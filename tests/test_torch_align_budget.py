"""The aligner's device-memory bounds (ops/align_device.py:DeviceAligner).

Like the JAX package's DeviceAligner, the port stages the whole corpus
([N, Lpad] int8) only when N x Lpad fits stage_mb MiB
(MESHCLUST_ALIGN_STAGE_MB, by default 40% of the card's memory); otherwise
each launch packs the distinct sequences of its own pairs. Each launch's
boundary rows, 36 B x P x (its largest l2 + 1), stay within BOUNDARY_SHARE
of the card's memory. Here, on the CPU (the kernel's plain version), with
forced budgets: stage_mb = 0 and boundary budgets that force launches of 1,
2 and 7 pairs, on corpora of mixed lengths with 'N' runs and one long
record. Identities must equal the staged path's and the JAX DeviceAligner's;
every launch must keep its budget and hold as many pairs as fit. Tolerance:
exact equality (integer DP).
"""
import numpy as np
import pytest
import torch

from meshclust_tpu_torch.ops import align_device as AD

torch.set_num_threads(1)


def _corpus(kind: str, seed: int = 5):
    """(codes, pairs): 'mixed' lengths 3-150 with 'N' (78) runs and one
    long record of 400 bases; 'uniform' all 60 long."""
    rng = np.random.default_rng(seed)
    n = 24
    lens = (np.full(n, 60) if kind == "uniform"
            else rng.integers(3, 151, size=n))
    if kind == "mixed":
        lens[7] = 400
    codes = []
    for i, L in enumerate(lens.tolist()):
        c = rng.integers(0, 4, size=L).astype(np.uint8)
        if kind == "mixed" and i % 3 == 0 and L > 12:
            p = int(rng.integers(0, L - 10))
            c[p: p + int(rng.integers(2, 10))] = 78
        codes.append(c)
    pairs = [(int(rng.integers(n)), int(rng.integers(n))) for _ in range(28)]
    pairs += [(7, 1), (2, 7), (7, 7)]
    return codes, pairs


def _rows_bytes(p: int, max_l2: int) -> int:
    """nw_align_long's boundary rows for p pairs."""
    return 4 * AD._PLANES * p * (max(1, max_l2) + 1)


def _force_budget(monkeypatch, budget: int) -> None:
    """BOUNDARY_SHARE set so that a launch may take `budget` bytes on the
    CPU."""
    monkeypatch.setattr(AD, "BOUNDARY_SHARE",
                        (budget + 0.5) / (AD.CPU_MEMORY_MB * 2 ** 20))


def _spy(monkeypatch):
    """nw_align_long recording each launch's (pairs, max_l2, codes rows,
    codes width, sequences addressed)."""
    launched = []
    kernel = AD.nw_align_long

    def spy(codes, lengths, ia, ib, max_l2, **kw):
        launched.append((ia.shape[0], max_l2, codes.shape[0], codes.shape[1],
                         torch.cat([ia, ib]).unique().numel(),
                         int(lengths.max())))
        return kernel(codes, lengths, ia, ib, max_l2, **kw)

    monkeypatch.setattr(AD, "nw_align_long", spy)
    return launched


@pytest.mark.parametrize("per_launch", [1, 2, 7])
@pytest.mark.parametrize("kind", ["mixed", "uniform"])
def test_unstaged_budgeted_identities_equal_staged_and_jax(monkeypatch, kind,
                                                           per_launch):
    """stage_mb = 0 and a boundary budget of per_launch pairs at the
    corpus's longest l2: identities equal the staged, unbudgeted path's and
    the JAX DeviceAligner's; every launch within its budget; every launch
    but the last full (one more pair would break the budget); on the
    uniform corpus exactly per_launch pairs a launch; and each launch ships
    only its own pairs' sequences, padded to its own longest (rounded up to
    128)."""
    from meshclust_tpu.ops.align_device import DeviceAligner as JAX
    codes, pairs = _corpus(kind)
    lens = np.asarray([len(c) for c in codes])
    want = AD.DeviceAligner(codes, "cpu").identities(pairs)
    np.testing.assert_array_equal(want, JAX(codes).identities(pairs))
    budget = _rows_bytes(per_launch, int(lens[[b for _, b in pairs]].max()))
    _force_budget(monkeypatch, budget)
    launched = _spy(monkeypatch)
    al = AD.DeviceAligner(codes, "cpu", stage_mb=0)
    assert not al._can_stage()
    np.testing.assert_array_equal(al.identities(pairs), want)
    assert al._staged is None
    assert sum(p for p, *_ in launched) == len(pairs)
    ia, ib = (np.asarray(x) for x in zip(*pairs))
    order = np.argsort(lens[ia] + lens[ib], kind="stable")
    l2 = lens[ib[order]]
    s = 0
    for p, max_l2, rows, width, used, longest in launched:
        assert max_l2 == l2[s: s + p].max()
        assert _rows_bytes(p, max_l2) <= budget
        if s + p < len(pairs):
            assert _rows_bytes(p + 1, max(max_l2, l2[s + p])) > budget
        assert rows == used <= 2 * p
        assert width == AD._round_up(max(longest, 8), 128)
        s += p
    assert any(p == per_launch for p, *_ in launched)
    if kind == "uniform":
        assert [p for p, *_ in launched[:-1]] == \
            [per_launch] * (len(launched) - 1)
    assert max(w for _, _, _, w, _, _ in launched) == AD._round_up(
        400 if kind == "mixed" else 60, 128)


def test_unstaged_path_never_builds_the_corpus_matrix(monkeypatch):
    """With stage_mb = 0 nothing calls _stage (the [N, Lpad] matrix);
    with the default stage_mb the corpus is staged once and every launch
    addresses it."""
    codes, pairs = _corpus("mixed")

    def refuse(self):
        raise AssertionError("the corpus was staged")

    want = AD.DeviceAligner(codes, "cpu").counts(pairs)
    with monkeypatch.context() as m:
        m.setattr(AD.DeviceAligner, "_stage", refuse)
        got = AD.DeviceAligner(codes, "cpu", stage_mb=0).counts(pairs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    launched = _spy(monkeypatch)
    al = AD.DeviceAligner(codes, "cpu")
    al.counts(pairs)
    assert al._staged is not None
    assert all(rows == len(codes) for _, _, rows, *_ in launched)


def test_a_pair_past_the_budget_launches_alone(monkeypatch):
    """A budget below one pair's boundary rows: every launch holds one
    pair, and the identities are unchanged."""
    codes, pairs = _corpus("mixed")
    want = AD.DeviceAligner(codes, "cpu").identities(pairs)
    _force_budget(monkeypatch, 1)
    launched = _spy(monkeypatch)
    got = AD.DeviceAligner(codes, "cpu", stage_mb=0).identities(pairs)
    np.testing.assert_array_equal(got, want)
    assert [p for p, *_ in launched] == [1] * len(pairs)


@pytest.mark.parametrize("l2,budget,want", [
    ([5, 5, 5, 5], 10 ** 9, [0, 4]),
    ([5, 5, 5, 5], 36 * 2 * 6, [0, 2, 4]),
    ([1, 1, 300, 1, 1], 36 * 2 * 301, [0, 2, 4, 5]),
    ([0, 0, 0], 36 * 3 * 2, [0, 3]),
    ([9, 9], 1, [0, 1, 2]),
])
def test_launch_cuts(l2, budget, want):
    """Greedy cuts: a launch takes pairs while its rows fit (l2 = 0 still
    takes one column), at least one."""
    assert AD.launch_cuts(np.asarray(l2), budget) == want


def test_launch_cuts_keep_pairs_per_launch(monkeypatch):
    monkeypatch.setattr(AD, "PAIRS_PER_LAUNCH", 3)
    assert AD.launch_cuts(np.full(8, 4), 10 ** 9) == [0, 3, 6, 8]


def test_stage_mb_is_read_as_jax_reads_it(monkeypatch):
    """MESHCLUST_ALIGN_STAGE_MB when stage_mb is not given, an explicit
    stage_mb over it, and the CPU's default 6,144 MB: the JAX package's
    DeviceAligner reads the same."""
    from meshclust_tpu.ops.align_device import DeviceAligner as JAX
    codes, _ = _corpus("mixed")
    monkeypatch.delenv("MESHCLUST_ALIGN_STAGE_MB", raising=False)
    assert AD.DeviceAligner(codes, "cpu").stage_mb == JAX(codes).stage_mb \
        == 6144
    monkeypatch.setenv("MESHCLUST_ALIGN_STAGE_MB", "0")
    al = AD.DeviceAligner(codes, "cpu")
    assert al.stage_mb == JAX(codes).stage_mb == 0
    assert al._can_stage() == JAX(codes)._can_stage() is False
    assert AD.DeviceAligner(codes, "cpu", stage_mb=7).stage_mb == 7
    # N x Lpad = 24 x 768 bytes: staged at 1 MiB
    monkeypatch.setenv("MESHCLUST_ALIGN_STAGE_MB", "1")
    assert AD.DeviceAligner(codes, "cpu")._can_stage() \
        == JAX(codes)._can_stage() is True


def test_kmer_run_unstaged_writes_the_staged_clstr(monkeypatch, tmp_path):
    """The k-mer path (its training labels pairs through the aligner) with
    MESHCLUST_ALIGN_STAGE_MB = 0 and launches of a few pairs writes the
    CLSTR of the staged run, and never stages the corpus."""
    from test_torch_end2end import run_port, write_corpus
    fasta = write_corpus(tmp_path / "c.fasta", 3, True)
    want = run_port(fasta, str(tmp_path / "staged.clstr"))
    monkeypatch.setenv("MESHCLUST_ALIGN_STAGE_MB", "0")
    _force_budget(monkeypatch, _rows_bytes(3, 180))
    launched = _spy(monkeypatch)

    def refuse(self):
        raise AssertionError("the corpus was staged")

    monkeypatch.setattr(AD.DeviceAligner, "_stage", refuse)
    assert run_port(fasta, str(tmp_path / "packed.clstr")) == want
    assert len(launched) > 1 and max(p for p, *_ in launched) <= 3
