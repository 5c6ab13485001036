"""Random field elements for the prover's permutation-argument retry
(reference plonky2/field/src/types.rs:40-131; the JAX package's
``iop/generator.py:rand_field_element``).

The state is explicit: a ``NonRandomRng`` (the reference's
``disable-randomness`` counter RNG) or a ``numpy.random.Generator``.  The
same counter start, or ``np.random.default_rng(seed)`` against the JAX
package's ``seed_randomness(seed)``, gives the same value sequence as the
JAX function.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np

U64 = (1 << 64) - 1


class NonRandomRng:
    """The reference's NonRandomRng (types.rs:49-77): ``next_u64`` returns
    counter + 1, counter + 2, ... (2, 3, 4, ... from the reset state of
    1); ``next_u32`` is its truncation."""

    def __init__(self, counter: int = 1):
        self.counter = counter

    def next_u64(self) -> int:
        self.counter += 1
        return self.counter & U64

    def next_u32(self) -> int:
        return self.next_u64() & 0xFFFFFFFF


Rng = Union[NonRandomRng, np.random.Generator]


def _uniform_sample_single(p: int, bits: int,
                           next_fn: Callable[[], int]) -> int:
    """rand 0.8.4 UniformInt<uN>::sample_single for gen_range(0..p): a
    widening multiply by p, rejected while the low half lies above the
    zone."""
    mask = (1 << bits) - 1
    lz = bits - p.bit_length()
    zone = ((p << lz) - 1) & mask
    while True:
        v = next_fn() & mask
        prod = v * p
        hi, lo = prod >> bits, prod & mask
        if lo <= zone:
            return hi


def rand_field_element(p: int, rng: Rng) -> int:
    """A field element of F_p drawn from ``rng``: with a ``NonRandomRng``,
    ``rng.gen_range(0..p)`` as the reference samples it (u64 for
    Goldilocks, u32 for BabyBear); otherwise 124 random bits reduced mod p
    (bias below 2^-64)."""
    if isinstance(rng, NonRandomRng):
        if p > 0xFFFFFFFF:
            return _uniform_sample_single(p, 64, rng.next_u64)
        return _uniform_sample_single(p, 32, rng.next_u32)
    hi = int(rng.integers(0, 1 << 62, dtype=np.int64))
    lo = int(rng.integers(0, 1 << 62, dtype=np.int64))
    return ((hi << 62) | lo) % p
