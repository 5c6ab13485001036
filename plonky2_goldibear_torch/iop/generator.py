"""Witness generators, their round-based scheduler, and the random field
elements that witness generation and the prover's permutation-argument
retry draw (reference plonky2/src/iop/generator.rs:25-106,228-460,
plonky2/field/src/types.rs:40-131; the JAX package's ``iop/generator.py``).

Generators run on the host over python ints.  The random state is explicit:
a ``NonRandomRng`` (the reference's ``disable-randomness`` counter RNG) or
a ``numpy.random.Generator``, passed by the caller of
``generate_partial_witness`` and kept on the ``PartitionWitness``.
``generate_partial_witness`` runs the fixpoint once for each set of
preset targets and replays its recorded schedule after that
(``native/``).  The
same counter start, or ``np.random.default_rng(seed)`` against the JAX
package's ``seed_randomness(seed)``, gives the same value sequence as the
JAX functions.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from . import target as tgt
from .witness import PartialWitness, PartitionWitness

U64 = (1 << 64) - 1


class NonRandomRng:
    """The reference's NonRandomRng (types.rs:49-77): its u64 words are
    counter + 1, counter + 2, ... mod 2^64 (2, 3, 4, ... from the reset
    state of 1), its u32 words their truncations; ``_counter_draws``
    consumes them."""

    def __init__(self, counter: int = 1):
        self.counter = counter


Rng = Union[NonRandomRng, np.random.Generator]


_M32 = np.uint64(0xFFFFFFFF)


def _mul_wide(v: np.ndarray, c: int):
    """(hi, lo) 64-bit halves of v * c, v a uint64 array, c < 2^64."""
    v = v.astype(np.uint64)
    vl, vh = v & _M32, v >> np.uint64(32)
    cl, ch = np.uint64(c & 0xFFFFFFFF), np.uint64(c >> 32)
    ll, lh, hl, hh = vl * cl, vl * ch, vh * cl, vh * ch
    mid = (ll >> np.uint64(32)) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | ((mid & _M32) << np.uint64(32))
    hi = hh + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) + \
        (mid >> np.uint64(32))
    return hi, lo


def _counter_draws(p: int, rng: NonRandomRng, n: int) -> np.ndarray:
    """n draws of rand 0.8.4's UniformInt<uN>::sample_single for
    gen_range(0..p) from the counter (u64 for Goldilocks, the u32
    truncation for BabyBear): a widening multiply by p, the counter values
    whose low half lies above the zone skipped."""
    bits = 64 if p > 0xFFFFFFFF else 32
    mask = (1 << bits) - 1
    zone = ((p << (bits - p.bit_length())) - 1) & mask
    out = []
    while n:
        k = n + 8 + n // 1024
        v = np.arange(k, dtype=np.uint64) + np.uint64((rng.counter + 1)
                                                      & U64)
        if bits == 32:
            prod = (v & _M32) * np.uint64(p)
            hi, lo = prod >> np.uint64(32), prod & _M32
        else:
            hi, lo = _mul_wide(v, p)
        ok = np.flatnonzero(lo <= np.uint64(zone))[:n]
        out.append(hi[ok])
        rng.counter += int(ok[-1]) + 1 if len(ok) == n else k
        n -= len(ok)
    return np.concatenate(out) if out else np.zeros(0, np.uint64)


def rand_field_elements(p: int, rng: Rng, n: int) -> np.ndarray:
    """n field elements of F_p drawn from ``rng`` (uint64): with a
    ``NonRandomRng``, ``rng.gen_range(0..p)`` as the reference samples it;
    otherwise 124 random bits reduced mod p (bias below 2^-64), two
    ``integers`` words an element.  Equal to n draws of one element."""
    if n == 0:
        return np.zeros(0, np.uint64)
    if isinstance(rng, NonRandomRng):
        return _counter_draws(p, rng, n)
    # python ints in an object array: 124-bit values, one C loop an op
    words = rng.integers(0, 1 << 62, size=2 * n,
                         dtype=np.int64).astype(object)
    return ((words[0::2] << 62 | words[1::2]) % p).astype(np.uint64)


def rand_field_element(p: int, rng: Rng) -> int:
    """One field element of F_p drawn from ``rng``."""
    return int(rand_field_elements(p, rng, 1)[0])


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


class RandomRowGenerator(SimpleGenerator):
    """Random values for ``wires`` of a blinding row, drawn at once (one
    ``RandomValueGenerator`` a wire in the reference,
    circuit_builder.rs:934-944; the same values in the same order)."""

    def __init__(self, row: int, wires, p: int):
        self.row = row
        self.wires = list(wires)
        self.p = p

    def dependencies(self):
        return []

    def run_once(self, witness, out):
        vals = rand_field_elements(self.p, witness.rng, len(self.wires))
        out.extend((tgt.wire(self.row, w), int(v))
                   for w, v in zip(self.wires, vals.tolist()))

    def replay_values(self, witness):
        """``run_once``'s draws as (dense wire indices, values), for the
        replay's bulk store (``native/schedule.py``)."""
        vals = rand_field_elements(self.p, witness.rng, len(self.wires))
        return self.row * witness.num_wires + np.asarray(self.wires), vals


def schedule_key(inputs: PartialWitness, common_data) -> frozenset:
    """The set of preset target indices a schedule is valid for."""
    nw, n = common_data.config.num_wires, common_data.degree
    return frozenset(tgt.target_index(t, nw, n)
                     for t in inputs.target_values)


def generate_partial_witness(inputs: PartialWitness, prover_data,
                             common_data, rng: Rng) -> PartitionWitness:
    """The witness of ``inputs``, drawing from ``rng``.

    The first call for a set of preset targets runs the fixpoint
    (``_fixpoint_generate``) and lowers its completion order into a
    schedule kept in ``prover_data.witgen_schedules``
    (``native/schedule.py``); every later call with the same set replays
    that schedule: the same values, and the same draws from ``rng`` in the
    same order.  A circuit witnessed once pays the lowering for nothing:
    a few ms for a dummy circuit, a fifth of the fixpoint for a recursive
    outer."""
    key = schedule_key(inputs, common_data)
    sched = prover_data.witgen_schedules.get(key)
    if sched is not None:
        return sched.replay(inputs, prover_data, common_data, rng)
    witness, order = _fixpoint_generate(inputs, prover_data, common_data,
                                        rng)
    # imported here: the lowerers import the gates, which import this module
    from ..native.schedule import compile_schedule

    prover_data.witgen_schedules[key] = compile_schedule(
        order, prover_data, common_data)
    return witness


def _fixpoint_generate(inputs: PartialWitness, prover_data, common_data,
                       rng: Rng):
    """The round-based fixpoint scheduler (reference generator.rs:25-106):
    every pending generator runs in list order, and each newly set
    representative queues its watchers for the next round.  ``rng`` feeds
    the random-value generators.  Returns the witness and the generators'
    completion order."""
    config = common_data.config
    generators = prover_data.generators
    by_watches: Dict[int, List[int]] = prover_data.generator_indices_by_watches

    witness = PartitionWitness(config.num_wires, common_data.degree,
                               prover_data.representative_map, rng)
    for t, v in inputs.target_values.items():
        witness.set_target(t, v)

    pending = list(range(len(generators)))
    expired = [False] * len(generators)
    order: List[int] = []
    buffer: List = []
    while pending:
        next_pending: List[int] = []
        for gi in pending:
            if expired[gi]:
                continue
            if generators[gi].run(witness, buffer):
                expired[gi] = True
                order.append(gi)
            for t, v in buffer:
                rep = witness.set_target_returning_rep(t, v)
                if rep is not None and rep in by_watches:
                    next_pending.extend(wgi for wgi in by_watches[rep]
                                        if not expired[wgi])
            buffer.clear()
        pending = next_pending

    remaining = len(generators) - len(order)
    assert remaining == 0, f"{remaining} generators weren't run"
    return witness, order
