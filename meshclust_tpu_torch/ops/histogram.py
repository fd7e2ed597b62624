"""K-mer histogram featurization on the device, the whole corpus at once.

Twin of meshclust_tpu/ops/histogram.py:featurize, with the same semantics
(KmerHashTable + fill_table): a dense 4^k count table per sequence,
initialized to `init` (the +1 pseudocount), counting the rolling base-4 id of
every k-mer window that lies wholly inside one segment chunk.

The count is the CUDA kernel csrc/kmer_hist.cu (`kmer_hist`), one launch per
corpus on the parser's flat codes (`flat_inputs`); it also produces the
1-mer counts, the exact int64 magnitude and sum of squares, and the largest
count. `kmer_hist_plain` is the same function in plain PyTorch (a
scatter-add over row * 4^k + id, the twin of the JAX package's
`histogram_xla`); `kmer_hist` takes it only for tensors on the CPU.

The histogram stays on the device in its storage dtype; only the narrow
per-sequence statistics come back to the host.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from meshclust_tpu_torch import _ext
from meshclust_tpu_torch.io import fasta as fio
from meshclust_tpu_torch.parallel import dist
from meshclust_tpu_torch.utils import perf

# ids are 2k bits of a 32-bit word
MAX_K = 15
# The kernel's shape (csrc/kmer_hist.cu: kBlock, kWarps, kClusterCtas,
# kMaxSharedK), checked against the source by
# tests/test_torch_kmer_schedule.py.
BLOCK = 16            # bases a lane takes a step: one aligned 16-byte load
WARPS = 8             # warps of a CTA
CLUSTER_CTAS = 2      # CTAs of a cluster in split mode
MAX_SHARED_K = 7      # bins in shared memory up to this k; global above
# The kernel counts inside a segment in 32-bit positions (the parser chunks
# segments at SEG_LENGTH, 1 Mb).
MAX_SEGMENT = 2 ** 31 - 64
# Corpora whose mean record length is at least this take split mode (a
# cluster of CTAs a record): a warp a record would leave most SMs idle.
LONG_RECORD = 4096


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def flat_inputs(seqs: List[fio.Sequence]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's inputs, as native.parse_fasta_native delivers them:
    codes [T] uint8 (every record's codes end to end, zero-padded to a
    multiple of BLOCK bytes), rec_off [N + 1] int64, segs [S, 2] int64
    (record-relative inclusive segments, record after record) and seg_off
    [N + 1] int64."""
    n = len(seqs)
    rec_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter((s.length for s in seqs), np.int64, count=n),
              out=rec_off[1:])
    total = int(rec_off[-1])
    codes = np.zeros(round_up(max(total, 1), BLOCK), np.uint8)
    if n:
        np.concatenate([s.codes for s in seqs], out=codes[:total])
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter((s.segments.shape[0] for s in seqs), np.int64,
                          count=n), out=seg_off[1:])
    segs = np.zeros((int(seg_off[-1]), 2), np.int64)
    if segs.shape[0]:
        np.concatenate([s.segments for s in seqs], out=segs)
        if int((segs[:, 1] - segs[:, 0]).max()) >= MAX_SEGMENT:
            raise ValueError(f"a segment of {MAX_SEGMENT} bases or more")
    return codes, rec_off, segs, seg_off


def split_mode(lengths: np.ndarray, k: int) -> bool:
    """Whether the kernel takes split mode (a cluster a record) for records
    of these lengths: k <= MAX_SHARED_K and a mean length of at least
    LONG_RECORD."""
    return (k <= MAX_SHARED_K and lengths.shape[0] > 0
            and float(lengths.mean()) >= LONG_RECORD)


def _marks(T: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """bool [T]: positions inside one of the ranges [lo, hi) (disjoint)."""
    d = torch.zeros(T + 1, dtype=torch.int64, device=lo.device)
    keep = hi > lo
    d.index_add_(0, lo[keep], torch.ones_like(lo[keep]))
    d.index_add_(0, hi[keep], -torch.ones_like(hi[keep]))
    return torch.cumsum(d, 0)[:T] > 0


def kmer_hist_plain(codes: torch.Tensor, rec_off: torch.Tensor,
                    segs: torch.Tensor, seg_off: torch.Tensor, k: int,
                    init: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kmer_hist kernel: a scatter-add over
    row * 4^k + id of every window start inside a segment. Same arguments
    and results as `kmer_hist`."""
    dev = codes.device
    n = rec_off.shape[0] - 1
    T = codes.shape[0]
    V = 4 ** k
    c = codes.to(torch.int64) & 3
    ids = torch.zeros_like(c)
    for i in range(k):
        ids = ids * 4 + torch.cat([c[i:], c.new_zeros(i)])
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   rec_off[1:] - rec_off[:-1])
    rows = torch.cat([rows, rows.new_zeros(T - rows.shape[0])])
    seg_rec = torch.repeat_interleave(torch.arange(n, device=dev),
                                      seg_off[1:] - seg_off[:-1])
    A = rec_off[seg_rec] + segs[:, 0]
    B = rec_off[seg_rec] + segs[:, 1]
    starts = _marks(T, A, B - k + 2)
    inseg = _marks(T, A, B + 1)
    counts = torch.zeros(n * V, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, (rows * V + ids)[starts],
                        torch.ones(int(starts.sum()), dtype=torch.int32,
                                   device=dev))
    counts = counts.reshape(n, V) + init
    ones = torch.zeros(n * 4, dtype=torch.int32, device=dev)
    ones.scatter_add_(0, (rows * 4 + c)[inseg],
                      torch.ones(int(inseg.sum()), dtype=torch.int32,
                                 device=dev))
    c64 = counts.to(torch.int64)
    largest = (counts.max().reshape(1) if n else
               torch.zeros(1, dtype=torch.int32, device=dev))
    return (counts, ones.reshape(n, 4), c64.sum(dim=1),
            (c64 * c64).sum(dim=1), largest)


def kmer_hist(codes: torch.Tensor, rec_off: torch.Tensor,
              segs: torch.Tensor, seg_off: torch.Tensor, k: int,
              init: int = 1, split: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, torch.Tensor]:
    """k-mer counts of N records in one launch.

    codes [T] uint8 (T a multiple of BLOCK), rec_off and seg_off [N + 1]
    int64, segs [S, 2] int64: `flat_inputs` on the device. `split` picks
    the kernel's split mode (`split_mode`); it changes no result. Returns
    counts [N, 4^k] int32 (with +init), 1-mer counts [N, 4] int32, mag and
    sq [N] int64, and largest [1] int32, the largest count.
    """
    if codes.dtype != torch.uint8 or codes.dim() != 1 \
            or not codes.is_contiguous() or codes.shape[0] % BLOCK:
        raise ValueError(f"codes must be a contiguous 1-D uint8 tensor of a "
                         f"multiple of {BLOCK} bytes")
    for name, t, dim in (("rec_off", rec_off, 1), ("seg_off", seg_off, 1),
                         ("segs", segs, 2)):
        if t.dtype != torch.int64 or t.dim() != dim \
                or not t.is_contiguous() or t.device != codes.device:
            raise ValueError(f"{name} must be a contiguous {dim}-D int64 "
                             f"tensor on the codes' device")
    n = rec_off.shape[0] - 1
    if n < 0 or seg_off.shape[0] != n + 1 or segs.shape[1] != 2 \
            or n >= 2 ** 31:
        raise ValueError("rec_off and seg_off must be [N + 1], segs [S, 2]")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}]")
    if codes.device.type == "cpu":
        return kmer_hist_plain(codes, rec_off, segs, seg_off, k, init)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if codes.data_ptr() % BLOCK:
        raise ValueError(f"codes must start on a {BLOCK}-byte boundary")
    dev = codes.device
    V = 4 ** k
    alloc = torch.zeros if k > MAX_SHARED_K else torch.empty
    counts = alloc((n, V), dtype=torch.int32, device=dev)
    ones = torch.empty((n, 4), dtype=torch.int32, device=dev)
    mag = torch.empty(n, dtype=torch.int64, device=dev)
    sq = torch.empty(n, dtype=torch.int64, device=dev)
    largest = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0:
        return counts, ones, mag, sq, largest
    err = _ext.lib().mc_kmer_hist(
        codes.data_ptr(), rec_off.data_ptr(), segs.data_ptr(),
        seg_off.data_ptr(), n, k, init, int(bool(split)), counts.data_ptr(),
        ones.data_ptr(), mag.data_ptr(), sq.data_ptr(), largest.data_ptr(),
        _ext.stream_of(codes))
    _ext._launched(err, "kmer_hist")
    return counts, ones, mag, sq, largest


_TORCH_DTYPE = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}


def featurize(seqs: List[fio.Sequence], k: int, device: torch.device,
              init: int = 1, mesh=None) -> dict:
    """Featurize all sequences on `device` in one kmer_hist launch: k-mer
    histograms (+pseudocount, written in place in input order and kept on
    the device in the storage dtype as `hist_dev`), 1-mer counts,
    magnitudes and sums of squares (host int64), lengths.

    With `mesh` (parallel/dist), each rank launches kmer_hist once on its
    contiguous block of records (balanced by bases), and the rows and
    statistics are gathered, so every rank returns the whole corpus's. The
    largest count is a MAX across ranks before the narrowing, and split
    mode is decided on every record's length, so every rank narrows and
    launches alike.

    Ref: ClusterFactory::build_points + get_divergence_point
    (ClusterFactory.cpp:770-804, 989-1010)."""
    device = torch.device(device)
    lengths = np.fromiter((s.length for s in seqs), np.int64,
                          count=len(seqs))
    mine = seqs
    if mesh is not None:
        off = dist.blocks(lengths, mesh.size)
        mine = seqs[off[mesh.rank]: off[mesh.rank + 1]]
    perf.add("feat_rows", float(len(mine)))
    with perf.phase("feat_pack"):
        codes, rec_off, segs, seg_off = (torch.from_numpy(a).to(device)
                                         for a in flat_inputs(mine))
    with perf.phase("feat_device"):
        hist_dev, ones, mag, sq, largest = kmer_hist(
            codes, rec_off, segs, seg_off, k, init,
            split=split_mode(lengths, k))
        if mesh is not None:
            hist_dev = dist.gather_rows(hist_dev, off, mesh, "featurize")
            stats = dist.gather_rows(
                torch.cat([ones.to(torch.int64), mag[:, None], sq[:, None]],
                          1), off, mesh, "featurize")
            ones, mag, sq = stats[:, :4], stats[:, 4], stats[:, 5]
            largest = dist.pmax(largest.to(torch.int64), mesh, "featurize")
    with perf.phase("feat_stats"):
        largest = int(largest[0])
        sdt = np.dtype(storage_dtype(largest))
        if sdt.itemsize < 4:
            hist_dev = hist_dev.to(_TORCH_DTYPE[sdt])
        one_mers = ones.cpu().numpy().astype(np.int64)
        mag = mag.cpu().numpy()
        sq = sq.cpu().numpy()
    return {
        "hist": None,
        "hist_dev": hist_dev,
        "one_mers": one_mers,
        "mag": mag,
        "sq": sq,
        "largest": largest,
        "lengths": lengths,
        "k": k,
        "V": 4 ** k,
    }


def find_k(per_file_seqs: List[List[fio.Sequence]]) -> int:
    """Auto k = ceil(log4(avg length)) - 1 with the reference's nested
    integer divisions (Runner.cpp:265-292)."""
    length = 0
    for seqs in per_file_seqs:
        if not seqs:
            continue
        l = 0
        for s in seqs:
            l += s.length
        l //= len(seqs)
        length += l
    length //= max(1, len(per_file_seqs))
    return int(np.ceil(np.log(max(length, 2)) / np.log(4.0))) - 1


def storage_dtype(largest_count: int):
    """Histogram storage dtype thresholds (ref Runner.cpp:75-89 uses u8/u16/
    u32/u64; TPU int8 is signed so the first step is 127)."""
    if largest_count <= 127:
        return np.int8
    if largest_count <= 32767:
        return np.int16
    if largest_count <= 2 ** 31 - 1:
        return np.int32
    return np.int64
