"""The circuit gadgets of the recursive verifier (reference
plonky2/src/gadgets/{select.rs, arithmetic.rs, split_join.rs,
split_base.rs, range_check.rs, random_access.rs, interpolation.rs},
util/reducing.rs ReducingFactorTarget, hash/merkle_proofs.rs:97-157; the
JAX package's ``plonk/gadgets.py``).

Each function takes the ``CircuitBuilder`` first.  An extension target is
a tuple of D targets; a bit is a target that the gate producing it
constrains to 0 or 1.  The order in which a gadget places gates, connects
wires and registers constants is the reference's: it decides the layout,
the sigmas and the circuit digest.
"""

from __future__ import annotations

from typing import List, Sequence

from ..field import host
from ..gates.access_gates import (BaseSumGate, ExponentiationGate,
                                  RandomAccessGate)
from ..gates.basic_gates import ArithmeticGate
from ..gates.coset_interpolation import CosetInterpolationGate
from ..gates.extension_gates import ArithmeticExtensionGate
from ..gates.reducing import ReducingExtensionGate, ReducingGate
from ..iop import generator as gen
from ..iop import target as tgt


# -- select and booleans -----------------------------------------------------


def select(b, bit, x, y):
    """bit ? x : y, as bit * (x - y) + y (select.rs)."""
    return b.arithmetic(1, 1, bit, b.sub(x, y), y)


def select_ext(b, bit, x, y):
    return tuple(select(b, bit, xc, yc) for xc, yc in zip(x, y))


def assert_bool(b, t):
    """t * t == t."""
    b.connect(b.mul(t, t), t)


# -- exponentiation ----------------------------------------------------------


def num_base_arithmetic_ops_per_gate(b) -> int:
    return ArithmeticGate.from_config(b.config).num_ops


def exp_from_bits(b, base, bits: Sequence):
    """base^(sum 2^i bit_i) through one ExponentiationGate
    (arithmetic.rs:275-296); bits little-endian, zero-padded to the gate's
    power-bit count."""
    gate = ExponentiationGate.from_config(b.config, b.spec)
    bits = list(bits)
    bits += [b.zero()] * (gate.num_power_bits - len(bits))
    row = b.add_gate(gate, [])
    b.connect(base, tgt.wire(row, gate.wire_base()))
    for i, bit in enumerate(bits):
        b.connect(bit, tgt.wire(row, gate.wire_power_bit(i)))
    return tgt.wire(row, gate.wire_output())


def exp_from_bits_const_base(b, base: int, bits_le: Sequence):
    """base^(sum 2^i bit_i) for a constant base, bits little-endian
    (arithmetic.rs:307-335): per bit, product = (base^(2^i) - 1) * product
    * bit + product, while the bits fit one arithmetic gate's ops."""
    p = b.spec.p
    bits = list(bits_le)
    # the reference registers the base before it picks a path
    # (arithmetic.rs:313); the order constants are registered in is in the
    # digest
    base_t = b.constant(base % p)
    if len(bits) > num_base_arithmetic_ops_per_gate(b):
        return exp_from_bits(b, base_t, bits)
    product = b.one()
    for i, bit in enumerate(bits):
        product = b.arithmetic((pow(base, 1 << i, p) - 1) % p, 1,
                               product, bit, product)
    return product


def exp_u64(b, base, exponent: int):
    """base^e with the exponent's bits as constants into one
    ExponentiationGate (arithmetic.rs:340-350)."""
    bits = []
    while exponent:
        bits.append(b.constant(exponent & 1))
        exponent >>= 1
    return exp_from_bits(b, base, bits)


def exp_power_of_2(b, x, k: int):
    """x^(2^k): k squarings while they fit one arithmetic gate, else the
    ExponentiationGate (arithmetic.rs:262-272)."""
    if k > num_base_arithmetic_ops_per_gate(b):
        return exp_u64(b, x, 1 << k)
    for _ in range(k):
        x = b.square(x)
    return x


def exp_power_of_2_extension(b, x, k: int):
    for _ in range(k):
        x = b.square_extension(x)
    return x


# -- bit decomposition -------------------------------------------------------


class _WireSplitGenerator(gen.SimpleGenerator):
    """An integer split across the sum wires of BaseSumGate rows, the low
    limbs first (split_join.rs:57-100)."""

    def __init__(self, integer, rows, num_limbs):
        self.integer = integer
        self.rows = rows
        self.num_limbs = num_limbs

    def dependencies(self):
        return [self.integer]

    def run_once(self, witness, out):
        v = witness.get_target(self.integer)
        for row in self.rows:
            out.append((tgt.wire(row, BaseSumGate.WIRE_SUM),
                        v & ((1 << self.num_limbs) - 1)))
            v >>= self.num_limbs
        assert v == 0, "integer too large for bit split"


def split_le(b, integer, num_bits: int) -> List:
    """The little-endian bits of ``integer`` (split_join.rs:27-62).  The
    sum is taken mod p, so a 64-bit split admits x + p beside x."""
    if num_bits == 0:
        return []
    gate = BaseSumGate.from_config(b.config, b.spec, 2)
    rows = [b.add_gate(gate, [])
            for _ in range(-(-num_bits // gate.num_limbs))]
    bits = [tgt.wire(row, limb) for row in rows for limb in gate.limbs()]
    for extra in bits[num_bits:]:
        b.assert_zero(extra)
    acc = b.zero()
    for row in reversed(rows):
        # mul_const_add routes the base as a constant target
        # (split_join.rs:48-55)
        acc = b.mul_const_add(pow(2, gate.num_limbs, b.spec.p), acc,
                              tgt.wire(row, BaseSumGate.WIRE_SUM))
    b.connect(acc, integer)
    b.add_simple_generator(_WireSplitGenerator(integer, rows,
                                               gate.num_limbs))
    return bits[:num_bits]


def low_bits(b, x, num_low_bits: int, noncanonical_ok: bool,
             num_bits: int) -> List:
    """range_check.rs:28-50; the canonicity check, which the default FRI
    configs of both fields do not need, is not ported."""
    assert noncanonical_ok, "the canonicity check is not ported"
    return split_le(b, x, num_bits)[:num_low_bits]


class _BaseSumGenerator(gen.SimpleGenerator):
    """A BaseSumGate row's sum from its limb bits (base_sum.rs, the
    le_sum gadget's use)."""

    def __init__(self, row, bits):
        self.row = row
        self.bits = list(bits)

    def dependencies(self):
        return list(self.bits)

    def run_once(self, witness, out):
        v = 0
        for i, t in enumerate(self.bits):
            v |= int(witness.get_target(t)) << i
        out.append((tgt.wire(self.row, BaseSumGate.WIRE_SUM), v))


def le_sum(b, bits: Sequence):
    """sum 2^i bit_i (split_base.rs le_sum): a chain of mul_add by a routed
    two while it fits one arithmetic gate, else one BaseSumGate row."""
    bits = list(bits)
    if not bits:
        return b.zero()
    if len(bits) - 1 <= num_base_arithmetic_ops_per_gate(b):
        two = b.two()
        acc = bits[-1]
        for bit in reversed(bits[:-1]):
            acc = b.mul_add(two, acc, bit)
        return acc
    gate = BaseSumGate.from_config(b.config, b.spec, 2)
    row = b.add_gate(gate, [])
    limbs = list(gate.limbs())
    for bit, w in zip(bits, limbs):
        b.connect(bit, tgt.wire(row, w))
    for w in limbs[len(bits):]:
        b.assert_zero(tgt.wire(row, w))
    b.add_simple_generator(_BaseSumGenerator(row, bits))
    return tgt.wire(row, BaseSumGate.WIRE_SUM)


def range_check(b, x, n_bits: int):
    """0 <= x < 2^n_bits."""
    split_le(b, x, n_bits)


def assert_leading_zeros(b, x, n: int):
    """x (64 bits) has at least n leading zeros (range_check.rs)."""
    range_check(b, x, 64 - n)


# -- random access -----------------------------------------------------------


def random_access(b, access_index, v: List):
    """v[access_index] through an op of a RandomAccessGate row
    (random_access.rs); len(v) is a power of two."""
    n = len(v)
    if n == 1:
        return v[0]
    gate = RandomAccessGate.from_config(b.config, host.log2_strict(n))
    claimed = b.add_virtual_target()
    row, copy = b.find_slot(gate, [], [])
    # the items, then the index, then the claimed element
    # (random_access.rs:30-40): the order shapes the copy-constraint forest
    for i, val in enumerate(v):
        b.connect(val, tgt.wire(row, gate.wire_list_item(i, copy)))
    b.connect(access_index, tgt.wire(row, gate.wire_access_index(copy)))
    b.connect(claimed, tgt.wire(row, gate.wire_claimed_element(copy)))
    return claimed


def random_access_extension(b, access_index, v: List) -> tuple:
    return tuple(random_access(b, access_index, [e[d] for e in v])
                 for d in range(b.D))


def random_access_hash(b, access_index, hashes: List[List]) -> List:
    return [random_access(b, access_index, [h[i] for h in hashes])
            for i in range(b.spec.num_hash_out_elts)]


# -- coset interpolation -----------------------------------------------------


def interpolate_coset(b, gate: CosetInterpolationGate, shift,
                      values: List, evaluation_point) -> tuple:
    """The interpolant of ``values`` on the coset shift * <g> at
    ``evaluation_point``, through one gate row (interpolation.rs)."""
    row = b.add_gate(gate, [])
    b.connect(shift, tgt.wire(row, gate.wire_shift()))
    for i, v in enumerate(values):
        for t, w in zip(v, gate.wires_value(i)):
            b.connect(t, tgt.wire(row, w))
    for t, w in zip(evaluation_point, gate.wires_evaluation_point()):
        b.connect(t, tgt.wire(row, w))
    return tuple(tgt.wire(row, w) for w in gate.wires_evaluation_value())


# -- reducing factor ---------------------------------------------------------


class ReducingFactorTarget:
    """Horner reductions by a fixed extension target, counting the terms
    reduced for a later ``shift`` (util/reducing.rs:125-280)."""

    def __init__(self, base_ext):
        self.base = base_ext
        self.count = 0

    def _fits_arithmetic(self, b, n: int) -> bool:
        return n <= ArithmeticExtensionGate.from_config(b.config,
                                                        b.D).num_ops + 1

    def reduce_base(self, terms: List, b) -> tuple:
        """Base-field terms: mul_add chains while they fit one arithmetic
        gate, else ReducingGate rows."""
        if self._fits_arithmetic(b, len(terms)):
            return self._reduce_arithmetic([b.convert_to_ext(t)
                                            for t in terms], b)
        max_len = ReducingGate.max_coeffs_len(
            b.config.num_wires, b.config.num_routed_wires, b.D)
        gate = ReducingGate(max_len, b.D)
        return self._reduce_gates(
            terms, b.zero(), max_len, gate,
            lambda row, j, t: b.connect(
                t, tgt.wire(row, gate.wires_coeff(j)[0])), b)

    def reduce(self, terms: List[tuple], b) -> tuple:
        """Extension terms: mul_add chains while they fit one arithmetic
        gate, else ReducingExtensionGate rows."""
        if self._fits_arithmetic(b, len(terms)):
            return self._reduce_arithmetic(terms, b)
        max_len = ReducingExtensionGate.max_coeffs_len(
            b.config.num_wires, b.config.num_routed_wires, b.D)
        gate = ReducingExtensionGate(max_len, b.D)
        return self._reduce_gates(
            terms, b.zero_extension(), max_len, gate,
            lambda row, j, t: b.connect_extension(
                t, tuple(tgt.wire(row, w) for w in gate.wires_coeff(j))), b)

    def _reduce_gates(self, terms, zero, max_len, gate, connect_coeff, b):
        """The terms padded with ``zero`` to a multiple of ``max_len``,
        reversed, ``max_len`` a row, each row's output the next row's old
        accumulator."""
        self.count += len(terms)
        acc = b.zero_extension()
        rev = list(terms) + [zero] * (-len(terms) % max_len)
        rev.reverse()
        for i in range(0, len(rev), max_len):
            row = b.add_gate(gate, [])
            b.connect_extension(self.base, tuple(
                tgt.wire(row, w) for w in gate.wires_alpha()))
            b.connect_extension(acc, tuple(
                tgt.wire(row, w) for w in gate.wires_old_acc()))
            for j, t in enumerate(rev[i:i + max_len]):
                connect_coeff(row, j, t)
            acc = tuple(tgt.wire(row, w) for w in gate.wires_output())
        return acc

    def _reduce_arithmetic(self, terms: List[tuple], b) -> tuple:
        self.count += len(terms)
        acc = b.zero_extension()
        for t in reversed(terms):
            acc = b.mul_add_extension(self.base, acc, t)
        return acc

    def shift(self, x, b) -> tuple:
        """x * base^count, then count = 0 (reducing.rs:262-280; a zero x
        skips the exponentiation)."""
        if x == b.zero_extension():
            exp = b.zero_extension()
        else:
            exp = b.exp_u64_extension(self.base, self.count)
        self.count = 0
        return b.mul_extension(exp, x)


# -- Merkle proofs in the circuit ---------------------------------------------


def verify_merkle_proof_to_cap_with_cap_index(b, leaf_data: List,
                                              leaf_index_bits: Sequence,
                                              cap_index, cap: List,
                                              siblings: List):
    """merkle_proofs.rs:116-157: hash the leaf, compress up the path (the
    index bit swaps the pair), then the cap entry at ``cap_index``."""
    n = b.spec.num_hash_out_elts
    zero = b.zero()
    state = b.hash_or_noop(leaf_data)
    for bit, sibling in zip(leaf_index_bits, siblings):
        inputs = list(state) + list(sibling)
        inputs += [zero] * (b.inner_hasher.WIDTH - len(inputs))
        state = b.permute_swapped(inputs, bit)[:n]
    for i in range(n):
        b.connect(random_access(b, cap_index, [h[i] for h in cap]), state[i])
