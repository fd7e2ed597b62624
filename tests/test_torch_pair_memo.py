"""Align mode's identity memo (utils/pair_memo.PairMemo) against the JAX
package's sorted-array _PairMemo, on the CPU.

Each case is a seeded stream of insert batches and lookups, replayed on the
port's memo, once with its native hash table and once with its numpy
fallback (MESHCLUST_NATIVE=0), and on meshclust_tpu.core.classify._PairMemo.
After every lookup `found` must be equal, and the values equal where found;
after every insert the exports (`keys`, `vals`, sorted by key) must equal
the original's contents, element for element. The original keeps a key
inserted twice twice (its lookup reads the first); the port keeps it once,
with that first value, so the original's contents are compared with a key's
first copy alone. AlignBackend inserts only keys its lookup missed, so in a
run the two hold the same pairs.
"""
import gc

import numpy as np
import pytest
import torch

from meshclust_tpu.core.classify import _PairMemo as JaxMemo
from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core.classify import AlignBackend
from meshclust_tpu_torch.core.runner import run
from meshclust_tpu_torch.utils import pair_memo as PM
from meshclust_tpu_torch.utils import perf
from tests.test_torch_end2end import write_corpus

torch.set_num_threads(1)
N = 15000


def _batch(rng, keys, share_old=0.0):
    """A batch's values, with a share of its keys replaced by keys already
    inserted (`keys`, a list of earlier batches)."""
    keys_new = keys[-1]
    if share_old and len(keys) > 1:
        old = np.concatenate(keys[:-1])
        pick = rng.random(keys_new.shape[0]) < share_old
        keys_new[pick] = rng.choice(old, int(pick.sum()))
    return keys_new, rng.random(keys_new.shape[0])


def case_empty(rng):
    yield "lookup", rng.integers(0, N * N, 50)
    yield "lookup", np.empty(0, np.int64)
    yield "insert", np.empty(0, np.int64), np.empty(0)
    yield "lookup", rng.integers(0, N * N, 50)


def case_one_key(rng):
    k = np.asarray([int(rng.integers(0, N * N))], np.int64)
    yield "insert", k, np.asarray([0.8125])
    yield "lookup", np.concatenate([k, k - 1, k + 1, k])


def case_extreme_keys(rng):
    ends = np.asarray([0, N * N - 1], np.int64)
    yield "insert", ends[1:], np.asarray([0.5])
    yield "lookup", np.asarray([0, 1, N * N - 2, N * N - 1], np.int64)
    yield "insert", ends[:1], np.asarray([0.25])
    yield "lookup", np.asarray([N * N - 1, 0, 0], np.int64)


def case_absent_lookups(rng):
    present = np.unique(rng.integers(0, N * N, 500))
    yield "insert", present, rng.random(present.shape[0])
    absent = np.setdiff1d(rng.integers(0, N * N, 2000), present)
    yield "lookup", absent
    yield "lookup", np.concatenate([absent, present[::7], absent + 1])


def case_reinsert_keeps_first(rng):
    keys = np.unique(rng.integers(0, N * N, 300))
    yield "insert", keys, rng.random(keys.shape[0])
    again = rng.permutation(keys)[:120]
    yield "insert", again, rng.random(again.shape[0]) + 2.0
    # a key twice in one batch, neither copy present before
    twin = np.asarray([N * N - 5, 3, N * N - 5], np.int64)
    yield "insert", twin, np.asarray([0.75, 0.5, 0.125])
    yield "lookup", np.concatenate([keys, twin, again])


def case_growth(rng):
    """~200k keys in batches of 5,000, a tenth of each batch's keys
    inserted before: the table doubles nine times, from 1,024 slots to
    524,288."""
    batches = []
    for _ in range(45):
        batches.append(rng.integers(0, N * N, 5000))
        keys, vals = _batch(rng, batches, share_old=0.1)
        yield "insert", keys, vals
        yield "lookup", np.concatenate([keys[::3],
                                        rng.integers(0, N * N, 500)])


CASES = {
    "empty": case_empty,
    "one_key": case_one_key,
    "extreme_keys": case_extreme_keys,
    "absent_lookups": case_absent_lookups,
    "reinsert_keeps_first": case_reinsert_keeps_first,
    "growth": case_growth,
}


@pytest.fixture(params=["native", "numpy"])
def kind(request, monkeypatch):
    monkeypatch.setenv("MESHCLUST_NATIVE",
                       "1" if request.param == "native" else "0")
    return request.param


def _port_memo(kind, n=N):
    memo = PM.PairMemo(n)
    assert (memo._h is not None) == (kind == "native")
    return memo


def _first_copies(memo):
    """The original's contents with each key once, at its first value."""
    keys, first = np.unique(memo.keys, return_index=True)
    return keys, memo.vals[first]


@pytest.mark.parametrize("case", sorted(CASES))
def test_memo_equals_original(case, kind):
    memo, ref = _port_memo(kind), JaxMemo(N)
    rng = np.random.default_rng(sorted(CASES).index(case) + 101)
    for op in CASES[case](rng):
        if op[0] == "insert":
            _, keys, vals = op
            memo.insert(keys, vals)
            ref.insert(np.asarray(keys, np.int64), vals)
            got_k, got_v = memo.keys, memo.vals
            want_k, want_v = _first_copies(ref)
            assert got_k.dtype == np.int64 and got_v.dtype == np.float64
            np.testing.assert_array_equal(got_k, want_k)
            np.testing.assert_array_equal(got_v, want_v)
        else:
            keys = np.asarray(op[1], np.int64)
            vals, found = memo.lookup(keys)
            want_v, want_f = ref.lookup(keys)
            assert vals.shape == found.shape == keys.shape
            np.testing.assert_array_equal(found, want_f)
            np.testing.assert_array_equal(vals[found], want_v[want_f])
            assert not vals[~found].any()


def test_counters_and_key_of(kind):
    """key_of is the original's; memo_hits counts the keys a lookup found,
    memo_inserts the keys an insert added."""
    memo, ref = _port_memo(kind, 40), JaxMemo(40)
    a = np.asarray([3, 39, 0, 7])
    b = np.asarray([39, 3, 0, 2])
    keys = memo.key_of(a, b)
    np.testing.assert_array_equal(keys, ref.key_of(a, b))
    perf.reset()
    memo.insert(keys, np.asarray([0.1, 0.2, 0.3, 0.4]))
    vals, found = memo.lookup(np.concatenate([keys, [5, 1599]]))
    assert found.tolist() == [True] * 4 + [False] * 2
    assert vals[:4].tolist() == [0.1, 0.1, 0.3, 0.4]
    assert perf.counters() == {"memo_inserts": 3.0, "memo_hits": 4.0}


def test_negative_key_refused(kind):
    memo = _port_memo(kind)
    memo.insert(np.asarray([4], np.int64), np.asarray([0.5]))
    with pytest.raises(ValueError):
        memo.insert(np.asarray([7, -1], np.int64), np.asarray([0.1, 0.2]))
    np.testing.assert_array_equal(memo.keys, [4])
    assert memo.lookup(np.asarray([-1, 7], np.int64))[1].tolist() \
        == [False, False]


def test_load_replaces_contents(kind):
    memo = _port_memo(kind)
    memo.insert(np.asarray([1, 9], np.int64), np.asarray([0.5, 0.25]))
    memo.load(np.asarray([2, 9, 40], np.int64),
              np.asarray([0.75, 0.125, 1.0]))
    np.testing.assert_array_equal(memo.keys, [2, 9, 40])
    np.testing.assert_array_equal(memo.vals, [0.75, 0.125, 1.0])
    assert memo.lookup(np.asarray([1], np.int64))[1].tolist() == [False]
    with pytest.raises(ValueError):
        memo.keys[0] = 3


def test_native_tables_freed_with_their_memos(monkeypatch, tmp_path):
    """Each native memo holds one table, freed when the memo (or the
    AlignBackend that owns it) is dropped, and by load() when it replaces
    the table: a process that runs align-mode jobs one after another (a
    benchmark window) holds one table at a time, with no wait for the
    cycle collector."""
    monkeypatch.setenv("MESHCLUST_NATIVE", "1")
    gc.collect()
    before = PM.live_tables()
    memos = [_port_memo("native") for _ in range(3)]
    for m in memos:
        m.insert(np.arange(3000, dtype=np.int64), np.full(3000, 0.5))
    assert PM.live_tables() == before + 3
    memos[0].load(np.asarray([5], np.int64), np.asarray([0.5]))
    assert PM.live_tables() == before + 3
    del m, memos
    assert PM.live_tables() == before
    fasta = write_corpus(tmp_path / "c.fasta", 4, False, n_species=3, per=8,
                         L=150)
    for job in range(2):
        res = run(ClusterConfig(files=[fasta], similarity=0.50,
                                output=str(tmp_path / f"{job}.clstr")),
                  device="cpu")
        assert isinstance(res["backend"], AlignBackend)
        assert res["backend"].memo._h is not None
        assert PM.live_tables() == before + 1
        del res
        assert PM.live_tables() == before
