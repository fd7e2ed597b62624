"""Bit-exact emulation of glibc rand()/srand() and libstdc++ random_shuffle.

The reference's only RNG use on the main path is one std::random_shuffle of
the sampled training pairs with a functor that reseeds srand(0) and returns
rand() % n (Trainer.cpp:245-252,277). Runner seeds srand(10) at startup
(Runner.cpp:38) but nothing consumes it before the reseed, so reproducing
glibc rand() with seed 0 reproduces the reference's pair order exactly.

glibc rand() (TYPE_3, the default for srand): an additive feedback generator
over 34 seeded + lagged uint32 words, trinomial x[i] = x[i-3] + x[i-31]
(mod 2^32), output = word >> 1, with 310 warm-up outputs discarded. Seed 0 is
mapped to 1. Verified bit-equal against compiled glibc in tests/test_rng.py.

libstdc++ std::random_shuffle(first, last, gen):
    for i in [1, n): swap(a[i], a[gen(i + 1)])
(bits/stl_algo.h; verified against compiled libstdc++ in tests).
"""
from __future__ import annotations

from typing import List, Sequence

_MASK32 = 0xFFFFFFFF


class GlibcRand:
    """glibc rand_r-family TYPE_3 generator (the `rand()` default)."""

    def __init__(self, seed: int):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        seed &= _MASK32
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        # LCG fill: r[i] = 16807 * r[i-1] % 2147483647, via Schrage to match
        # glibc's signed arithmetic exactly.
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & _MASK32
        self._r: List[int] = r[-31:]  # rolling window of the last 31 words
        # next output index k corresponds to r[k]; we keep only what we need:
        # new word = r[k-31] + r[k-3].

    def rand(self) -> int:
        r = self._r
        word = (r[0] + r[28]) & _MASK32
        r.append(word)
        del r[0]
        return word >> 1


def random_shuffle(items: list, seed: int = 0) -> list:
    """In-place libstdc++ std::random_shuffle with glibc `rand() % n` functor.

    Matches `rng` + `std::random_shuffle(vec.begin(), vec.end(), gen)` at
    Trainer.cpp:245-277. Returns `items` for convenience.
    """
    gen = GlibcRand(seed)
    n = len(items)
    for i in range(1, n):
        j = gen.rand() % (i + 1)
        items[i], items[j] = items[j], items[i]
    return items
