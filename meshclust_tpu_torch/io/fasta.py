"""FASTA parsing, nucleotide encoding, and N-segment extraction.

Reproduces the reference front-end semantics:
- multi-record streaming parse with CR/LF-safe line handling
  (ChromListMaker.cpp:23-47, makeChromOneDigitList :92-120 — note this code
  path has NO header-continuation handling; every non-'>' line is sequence),
- uppercase + N-run removal into inclusive [start, end] segments
  (Chromosome.cpp:153-184),
- merge segments with gaps < 10, drop segments < 20 bp (Chromosome.cpp:190-226),
- chunk segments to <= 1 Mbp (Chromosome.cpp:228-258),
- encode A,C,G,T -> 0..3 with IUPAC ambiguity codes mapped to fixed bases;
  non-segment N positions keep the literal 'N' byte (0x4E) so alignment
  treats N==N as a match (ChromosomeOneDigit.cpp:59-144).

The parser is numpy-vectorized per record; a native C++ fast path can slot in
behind the same API (see native/).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional, Tuple

import numpy as np

from meshclust_tpu_torch.errors import FileDoesNotExistError, InvalidInputError

N_BYTE = ord("N")  # 78: literal N kept in code arrays outside segments

# 256-entry LUT: ChromosomeOneDigit::buildCodes (ChromosomeOneDigit.cpp:59-85).
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in {
    "A": 0, "C": 1, "G": 2, "T": 3,
    "R": 2, "Y": 1, "M": 0, "K": 3, "S": 2, "W": 3,
    "H": 1, "B": 3, "V": 0, "D": 3, "N": 1, "X": 2,
}.items():
    _CODE_LUT[ord(_ch)] = _code

# toupper for bytes (Chromosome::toUpperCase, Chromosome.cpp:153-157)
_UPPER_LUT = np.arange(256, dtype=np.uint8)
for _c in range(ord("a"), ord("z") + 1):
    _UPPER_LUT[_c] = _c - 32

SEG_LENGTH = 1_000_000  # Chromosome::help(1000000, true) (Chromosome.cpp:94)
MIN_SEG = 20            # segments shorter than 20 bp dropped (Chromosome.cpp:203)
MERGE_GAP = 10          # gaps < 10 bp merged (Chromosome.cpp:200)


@dataclasses.dataclass
class Sequence:
    """One FASTA record after reference-equivalent preprocessing."""

    header: str                 # full header line INCLUDING '>'
    codes: np.ndarray           # uint8 [L]: 0..3 digits, 78 for N runs
    segments: np.ndarray        # int64 [S, 2] inclusive coords, post merge+chunk

    @property
    def length(self) -> int:
        return int(self.codes.shape[0])


def _find_segments(is_n: np.ndarray) -> np.ndarray:
    """Maximal non-N runs as inclusive [start, end] rows (removeN)."""
    if is_n.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int64)
    padded = np.concatenate(([True], is_n, [True]))
    diff = np.diff(padded.astype(np.int8))
    starts = np.nonzero(diff == -1)[0]
    ends = np.nonzero(diff == 1)[0] - 1
    return np.stack([starts, ends], axis=1).astype(np.int64)


def _merge_segments(segs: np.ndarray) -> np.ndarray:
    """mergeSegments: merge gaps < MERGE_GAP, drop runs < MIN_SEG bp."""
    if segs.shape[0] == 0:
        return segs
    # Merge: a boundary survives iff next_start - cur_end >= MERGE_GAP.
    keep = segs[1:, 0] - segs[:-1, 1] >= MERGE_GAP
    group = np.concatenate(([0], np.cumsum(keep)))
    n_groups = group[-1] + 1
    # starts = first start per group; ends = last end per group
    first_idx = np.searchsorted(group, np.arange(n_groups), side="left")
    last_idx = np.searchsorted(group, np.arange(n_groups), side="right") - 1
    starts = segs[first_idx, 0]
    ends = segs[last_idx, 1]
    merged = np.stack([starts, ends], axis=1)
    long_enough = merged[:, 1] - merged[:, 0] + 1 >= MIN_SEG
    return merged[long_enough]


def _chunk_segments(segs: np.ndarray, seg_length: int = SEG_LENGTH) -> np.ndarray:
    """makeSegmentList: split runs > seg_length into fragNum pieces.

    Mirrors Chromosome.cpp:228-258: fragNum = floor(len / segLength); the
    last fragment absorbs the remainder; fragments are adjacent (so k-mers
    spanning a chunk boundary are NOT counted — preserved behavior).
    """
    if segs.shape[0] == 0:
        return segs
    out: List[np.ndarray] = []
    for s, e in segs:
        ln = e - s + 1
        if ln > seg_length:
            frag_num = int(ln // seg_length)
            starts = s + np.arange(frag_num, dtype=np.int64) * seg_length
            ends = starts + seg_length - 1
            ends[-1] = e
            out.append(np.stack([starts, ends], axis=1))
        else:
            out.append(np.array([[s, e]], dtype=np.int64))
    return np.concatenate(out, axis=0)


def encode_record(header: str, seq_bytes: bytes) -> Optional[Sequence]:
    """Uppercase, segment, and digit-encode one record.

    Returns None for records the reference cannot process (empty sequence /
    all-N sequence crash the reference's mergeSegments; we skip with the same
    net effect of "no usable data" but without dying — documented divergence).
    """
    raw = _UPPER_LUT[np.frombuffer(seq_bytes, dtype=np.uint8)]
    return _encode_upper(header, raw)


def _encode_upper(header: str, raw: np.ndarray) -> Optional[Sequence]:
    if raw.shape[0] == 0:
        return None
    # fast path: no Ns at all (the common case for read data)
    if not (raw == N_BYTE).any():
        codes = _CODE_LUT[raw]
        bad = codes == 255
        if bad.any():
            pos = int(np.nonzero(bad)[0][0])
            raise InvalidInputError(
                f"Invalid nucleotide {chr(int(raw[pos]))!r} at position "
                f"{pos} in record {header!r}")
        L = raw.shape[0]
        if L >= MIN_SEG:
            segs = _chunk_segments(np.array([[0, L - 1]], dtype=np.int64))
        else:
            segs = np.zeros((0, 2), dtype=np.int64)
        return Sequence(header=header, codes=codes, segments=segs)
    is_n = raw == N_BYTE
    segs = _merge_segments(_find_segments(is_n))
    segs = _chunk_segments(segs)

    codes = _CODE_LUT[raw]
    bad = codes == 255
    if bad.any() and bool(bad[~is_n].any()):
        pos = int(np.nonzero(bad & ~is_n)[0][0])
        raise InvalidInputError(
            f"Invalid nucleotide {chr(int(raw[pos]))!r} at position {pos} in "
            f"record {header!r}"
        )
    # ChromosomeOneDigit::encodeNucleotides: positions INSIDE (merged)
    # segments are always encoded via the codes map — including N's absorbed
    # by mergeSegments (N->C). Only N's OUTSIDE segments keep the literal 'N'
    # byte (ChromosomeOneDigit.cpp:95-144).
    inseg = np.zeros(raw.shape[0], dtype=bool)
    for _s, _e in segs:
        inseg[_s: _e + 1] = True
    codes = np.where(is_n & ~inseg, np.uint8(N_BYTE), codes)
    if raw.shape[0] == 0:
        return None
    return Sequence(header=header, codes=codes, segments=segs)


def iter_fasta_records(path: str) -> Iterable[tuple]:
    """Yield (header_line, seq_bytes) per record, CR/LF-safe."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError as e:
        raise FileDoesNotExistError(f'File "{path}" does not exist') from e
    # safe_getline semantics: split on \n, strip one trailing \r.
    header: Optional[bytes] = None
    chunks: List[bytes] = []
    for line in data.split(b"\n"):
        if line.endswith(b"\r"):
            line = line[:-1]
        if line.startswith(b">"):
            if header is not None:
                yield header.decode("utf-8", "replace"), b"".join(chunks)
            header = line
            chunks = []
        elif header is not None:
            chunks.append(line)
        # leading junk before the first '>' is dropped (ref appends to an
        # uninitialized Chromosome -> UB; we ignore it)
    if header is not None:
        yield header.decode("utf-8", "replace"), b"".join(chunks)


def read_fasta(path: str) -> List[Sequence]:
    """Parse one multi-FASTA file into preprocessed Sequences.

    Fast paths in order: native C++ parser (meshclust_tpu_torch/native/, multi-
    threaded, same semantics — falls back on any error so the numpy path
    produces the reference-matching diagnostics), then the vectorized numpy
    whole-file path, then the streaming parser (CR line endings)."""
    native = _read_fasta_native(path)
    if native is not None:
        return native
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError as e:
        raise FileDoesNotExistError(f'File "{path}" does not exist') from e
    if b"\r" in data[:65536]:
        return _read_fasta_streaming(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.shape[0] == 0:
        return []
    nl = np.nonzero(buf == ord("\n"))[0]
    # line start offsets
    starts = np.concatenate(([0], nl + 1))
    ends = np.concatenate((nl, [buf.shape[0]]))
    keep = starts < ends  # drop empty trailing line
    starts, ends = starts[keep], ends[keep]
    if starts.shape[0] == 0:
        return []
    is_header = buf[starts] == ord(">")
    header_rows = np.nonzero(is_header)[0]
    if header_rows.shape[0] == 0:
        return []

    upper = _UPPER_LUT[buf]
    out: List[Sequence] = []
    n_lines = starts.shape[0]
    for h_i, row in enumerate(header_rows):
        header = data[starts[row]: ends[row]].decode("utf-8", "replace")
        last = (header_rows[h_i + 1] if h_i + 1 < header_rows.shape[0]
                else n_lines)
        segs = [upper[starts[r]: ends[r]] for r in range(row + 1, last)]
        if not segs:
            continue
        raw = segs[0] if len(segs) == 1 else np.concatenate(segs)
        rec = _encode_upper(header, raw)
        if rec is not None:
            out.append(rec)
    return out


def _read_fasta_native(path: str) -> Optional[List[Sequence]]:
    """C++ parser path; None -> fall through to the numpy paths."""
    try:
        from meshclust_tpu_torch import native
        if not native.enabled():
            return None
        parsed = native.parse_fasta_native(path)
    except Exception:
        return None
    if parsed is None:
        if not os.path.isfile(path):
            raise FileDoesNotExistError(f'File "{path}" does not exist')
        return None
    headers, codes, rec_off, segs, seg_off = parsed
    out: List[Sequence] = []
    for i, h in enumerate(headers):
        c = codes[rec_off[i]: rec_off[i + 1]]
        s = segs[seg_off[i]: seg_off[i + 1]]
        out.append(Sequence(header=h, codes=c, segments=s))
    return out


def _read_fasta_streaming(data: bytes) -> List[Sequence]:
    out: List[Sequence] = []
    header: Optional[bytes] = None
    chunks: List[bytes] = []
    for line in data.split(b"\n"):
        if line.endswith(b"\r"):
            line = line[:-1]
        if line.startswith(b">"):
            if header is not None:
                rec = encode_record(header.decode("utf-8", "replace"),
                                    b"".join(chunks))
                if rec is not None:
                    out.append(rec)
            header = line
            chunks = []
        elif header is not None:
            chunks.append(line)
    if header is not None:
        rec = encode_record(header.decode("utf-8", "replace"),
                            b"".join(chunks))
        if rec is not None:
            out.append(rec)
    return out


def read_fasta_files(paths: List[str]) -> List[Sequence]:
    """Parse many files. Caller is responsible for basename-sorting paths
    (Runner.cpp:253-262); see core/runner.py."""
    out: List[Sequence] = []
    for p in paths:
        out.extend(read_fasta(p))
    return out


def kmer_valid_starts(seq: Sequence, k: int) -> np.ndarray:
    """bool [L]: position p starts a counted k-mer (within one segment chunk).

    Matches fill_table (ClusterFactory.h:40-55): for each segment [s, e],
    k-mer starts s .. e-k+1 are counted.
    """
    valid = np.zeros(seq.length, dtype=bool)
    for s, e in seq.segments:
        if e - k + 1 >= s:
            valid[s: e - k + 2] = True
    return valid


def in_segment_mask(seq: Sequence) -> np.ndarray:
    """bool [L]: position lies inside some (merged, chunked) segment."""
    mask = np.zeros(seq.length, dtype=bool)
    for s, e in seq.segments:
        mask[s: e + 1] = True
    return mask


def read_fasta_plain(path: str) -> List[Tuple[str, str]]:
    """Reference `ChromListMaker::makeChromList` semantics
    (src/nonltr/ChromListMaker.cpp:49-89): the ORIGINAL
    sequence letters are kept (uppercased at finalize, Chromosome.cpp:105),
    and a line starting with a space/tab is a HEADER CONTINUATION (appended
    verbatim to the current header; all-whitespace lines are skipped).  Used
    by Red's masked-output pass, where original IUPAC letters must survive;
    the one-digit analysis reader (read_fasta) has no continuation handling,
    exactly like makeChromOneDigitList.  Returns [(header, seq)] with the
    header including '>'.
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError as e:
        raise FileDoesNotExistError(f'File "{path}" does not exist') from e
    out: List[Tuple[str, str]] = []
    header: Optional[str] = None
    chunks: List[bytes] = []
    for line in data.split(b"\n"):
        if line.endswith(b"\r"):
            line = line[:-1]
        if line.startswith(b">"):
            if header is not None:
                out.append((header, b"".join(chunks).upper().decode(
                    "utf-8", "replace")))
            header = line.decode("utf-8", "replace")
            chunks = []
        elif line[:1] in (b" ", b"\t"):
            if header is None or not line.strip():
                continue
            header += line.decode("utf-8", "replace")
        elif header is not None:
            chunks.append(line)
    if header is not None:
        out.append((header, b"".join(chunks).upper().decode(
            "utf-8", "replace")))
    return out
