"""Witness generators, their round-based scheduler, and the random field
elements that witness generation and the prover's permutation-argument
retry draw (reference plonky2/src/iop/generator.rs:25-106,228-460,
plonky2/field/src/types.rs:40-131; the JAX package's ``iop/generator.py``).

Generators run on the host over python ints.  The random state is explicit:
a ``NonRandomRng`` (the reference's ``disable-randomness`` counter RNG) or
a ``numpy.random.Generator``, passed by the caller of
``generate_partial_witness`` and kept on the ``PartitionWitness``.  The
same counter start, or ``np.random.default_rng(seed)`` against the JAX
package's ``seed_randomness(seed)``, gives the same value sequence as the
JAX functions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Union

import numpy as np

from . import target as tgt
from .witness import PartialWitness, PartitionWitness

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


class SimpleGenerator:
    """dependencies() -> run_once when all of them are set
    (reference generator.rs:228-265)."""

    def dependencies(self) -> List[tgt.Target]:
        raise NotImplementedError

    def run_once(self, witness: PartitionWitness, out: List):
        raise NotImplementedError

    def watch_list(self) -> List[tgt.Target]:
        return self.dependencies()

    def run(self, witness: PartitionWitness, out: List) -> bool:
        if witness.contains_all(self.dependencies()):
            self.run_once(witness, out)
            return True
        return False


class ConstantGenerator(SimpleGenerator):
    """A constant gate's wire (reference generator.rs:450,
    gates/constant.rs)."""

    def __init__(self, row: int, constant_index: int, wire_index: int,
                 constant: int):
        self.row = row
        self.constant_index = constant_index
        self.wire_index = wire_index
        self.constant = constant

    def dependencies(self):
        return []

    def run_once(self, witness, out):
        out.append((tgt.wire(self.row, self.wire_index), self.constant))


class CopyGenerator(SimpleGenerator):
    """Copies a value from src to dst (reference generator.rs:320)."""

    def __init__(self, src: tgt.Target, dst: tgt.Target):
        self.src = src
        self.dst = dst

    def dependencies(self):
        return [self.src]

    def run_once(self, witness, out):
        out.append((self.dst, witness.get_target(self.src)))


class RandomValueGenerator(SimpleGenerator):
    """A value drawn from the witness's rng (reference generator.rs:362)."""

    def __init__(self, target: tgt.Target, p: int):
        self.target = target
        self.p = p

    def dependencies(self):
        return []

    def run_once(self, witness, out):
        out.append((self.target, rand_field_element(self.p, witness.rng)))


def generate_partial_witness(inputs: PartialWitness, prover_data,
                             common_data, rng: Rng) -> PartitionWitness:
    """The round-based fixpoint scheduler (reference generator.rs:25-106):
    every pending generator runs in list order, and each newly set
    representative queues its watchers for the next round.  ``rng`` feeds
    the random-value generators."""
    config = common_data.config
    generators = prover_data.generators
    by_watches: Dict[int, List[int]] = prover_data.generator_indices_by_watches

    witness = PartitionWitness(config.num_wires, common_data.degree,
                               prover_data.representative_map, rng)
    for t, v in inputs.target_values.items():
        witness.set_target(t, v)

    pending = list(range(len(generators)))
    expired = [False] * len(generators)
    remaining = len(generators)
    buffer: List = []
    while pending:
        next_pending: List[int] = []
        for gi in pending:
            if expired[gi]:
                continue
            if generators[gi].run(witness, buffer):
                expired[gi] = True
                remaining -= 1
            for t, v in buffer:
                rep = witness.set_target_returning_rep(t, v)
                if rep is not None and rep in by_watches:
                    next_pending.extend(wgi for wgi in by_watches[rep]
                                        if not expired[wgi])
            buffer.clear()
        pending = next_pending

    assert remaining == 0, f"{remaining} generators weren't run"
    return witness
