"""RandomAccessGate, BaseSumGate and ExponentiationGate (reference
plonky2/src/gates/{random_access.rs, base_sum.rs, exponentiation.rs}; the
JAX package's ``gates/access_gates.py``).  The recursive verifier's list
lookups (``plonk/gadgets.py:random_access``) and bit splits
(``split_le``) place the first two; its FRI query's x = g^index places an
ExponentiationGate where the index has more bits than one arithmetic gate
has ops (``exp_from_bits_const_base``: the BabyBear outer over a 2^12
inner).
"""

from __future__ import annotations

from ..field import host
from ..iop import generator as gen
from ..iop import target as tgt
from .base import Gate

# the reference's Debug name of each field type, in a gate id
FIELD_TYPE = {"goldilocks": "plonky2_field::goldilocks_field::GoldilocksField",
              "babybear": "p3_baby_bear::baby_bear::BabyBear"}


class RandomAccessGate(Gate):
    """claimed_element == list[access_index], through the bits of the
    index and a log-depth fold of the list; each copy's routed wires are
    the index, the claimed element and the 2^bits items, then the extra
    constants, then the non-routed bits of every copy (reference
    random_access.rs:32-200)."""

    def __init__(self, bits: int, num_copies: int, num_extra_constants: int):
        self.bits = bits
        self.num_copies = num_copies
        self.num_ops = num_copies
        self.num_extra_constants = num_extra_constants

    @classmethod
    def from_config(cls, config, bits: int):
        """As many copies as the wires hold; the routed wires left over
        carry extra constants (reference random_access.rs:46-66)."""
        vec_size = 1 << bits
        max_copies = min(config.num_routed_wires // (2 + vec_size),
                         config.num_wires // (2 + vec_size + bits))
        max_extra = config.num_routed_wires - (2 + vec_size) * max_copies
        return cls(bits, max_copies, min(max_extra, config.num_constants))

    def id(self):
        return (f"RandomAccessGate {{ bits: {self.bits}, num_copies: "
                f"{self.num_copies}, num_extra_constants: "
                f"{self.num_extra_constants} }}")

    @property
    def vec_size(self):
        return 1 << self.bits

    def wire_access_index(self, copy):
        return (2 + self.vec_size) * copy

    def wire_claimed_element(self, copy):
        return (2 + self.vec_size) * copy + 1

    def wire_list_item(self, i, copy):
        return (2 + self.vec_size) * copy + 2 + i

    def wire_extra_constant(self, i):
        return (2 + self.vec_size) * self.num_copies + i

    def num_routed(self):
        return self.wire_extra_constant(self.num_extra_constants)

    def wire_bit(self, i, copy):
        return self.num_routed() + copy * self.bits + i

    def num_wires(self):
        return self.wire_bit(self.bits - 1, self.num_copies - 1) + 1

    def num_constants(self):
        return self.num_extra_constants

    def degree(self):
        return self.bits + 1

    def num_constraints(self):
        return self.num_copies * (self.bits + 2) + self.num_extra_constants

    def extra_constant_wires(self):
        return [(i, self.wire_extra_constant(i))
                for i in range(self.num_extra_constants)]

    def generators(self, row, local_constants, spec):
        return [_RandomAccessGenerator(self, row, copy)
                for copy in range(self.num_copies)]

    def eval_unfiltered(self, A, vars):
        lw = vars.local_wires
        one = A.one()
        out = []
        for copy in range(self.num_copies):
            items = [lw[self.wire_list_item(i, copy)]
                     for i in range(self.vec_size)]
            bits = [lw[self.wire_bit(i, copy)] for i in range(self.bits)]
            out += [A.mul(b, A.sub(b, one)) for b in bits]
            recon = A.zero()
            for b in reversed(bits):
                recon = A.add(A.add(recon, recon), b)
            out.append(A.sub(recon, lw[self.wire_access_index(copy)]))
            for b in bits:
                items = [A.add(items[2 * i],
                               A.mul(b, A.sub(items[2 * i + 1],
                                              items[2 * i])))
                         for i in range(len(items) // 2)]
            out.append(A.sub(items[0], lw[self.wire_claimed_element(copy)]))
        out += [A.sub(vars.local_constants[i], lw[self.wire_extra_constant(i)])
                for i in range(self.num_extra_constants)]
        return out


class BaseSumGate(Gate):
    """sum = sum_i limb_i B^i with each limb in [0, B); wire 0 is the sum,
    wires 1.. the limbs (reference base_sum.rs:25-150)."""

    WIRE_SUM = 0
    START_LIMBS = 1

    def __init__(self, num_limbs: int, base: int):
        self.num_limbs = num_limbs
        self.base = base

    @classmethod
    def from_config(cls, config, spec, base: int):
        """floor(log_base(p - 1)) limbs, as far as the routed wires allow
        (reference base_sum.rs:33-40)."""
        n, v = 0, spec.p - 1
        while v >= base:
            v //= base
            n += 1
        return cls(min(n, config.num_routed_wires - cls.START_LIMBS), base)

    def id(self):
        return (f"BaseSumGate {{ num_limbs: {self.num_limbs} }} + Base: "
                f"{self.base}")

    def limbs(self):
        return range(self.START_LIMBS, self.START_LIMBS + self.num_limbs)

    def num_wires(self):
        return 1 + self.num_limbs

    def num_constants(self):
        return 0

    def degree(self):
        return self.base

    def num_constraints(self):
        return 1 + self.num_limbs

    def generators(self, row, local_constants, spec):
        return [_BaseSplitGenerator(self, row)]

    def eval_unfiltered(self, A, vars):
        limbs = [vars.local_wires[i] for i in self.limbs()]
        computed = A.zero()
        for limb in reversed(limbs):
            computed = A.add(A.mul_base_const(computed, self.base), limb)
        out = [A.sub(computed, vars.local_wires[self.WIRE_SUM])]
        for limb in limbs:
            # a chain of products, as the reference's circuit form emits it
            acc = None
            for i in range(self.base):
                term = A.add_base_const(limb, (-i) % A.spec.p)
                acc = term if acc is None else A.mul(acc, term)
            out.append(acc)
        return out


class _RandomAccessGenerator(gen.SimpleGenerator):
    """The claimed element and the index bits of one copy."""

    def __init__(self, gate, row, copy):
        self.gate, self.row, self.copy = gate, row, copy

    def dependencies(self):
        g, c = self.gate, self.copy
        return [tgt.wire(self.row, w) for w in
                [g.wire_access_index(c)]
                + [g.wire_list_item(i, c) for i in range(g.vec_size)]]

    def run_once(self, witness, out):
        g, c = self.gate, self.copy
        idx = witness.get_target(tgt.wire(self.row, g.wire_access_index(c)))
        assert idx < g.vec_size, f"access index {idx} >= {g.vec_size}"
        out.append((tgt.wire(self.row, g.wire_claimed_element(c)),
                    witness.get_target(
                        tgt.wire(self.row, g.wire_list_item(idx, c)))))
        for i in range(g.bits):
            out.append((tgt.wire(self.row, g.wire_bit(i, c)),
                        (idx >> i) & 1))


class _BaseSplitGenerator(gen.SimpleGenerator):
    """The limbs of the sum, least significant first."""

    def __init__(self, gate, row):
        self.gate, self.row = gate, row

    def dependencies(self):
        return [tgt.wire(self.row, BaseSumGate.WIRE_SUM)]

    def run_once(self, witness, out):
        g = self.gate
        v = witness.get_target(tgt.wire(self.row, BaseSumGate.WIRE_SUM))
        for i in g.limbs():
            out.append((tgt.wire(self.row, i), v % g.base))
            v //= g.base
        assert v == 0, "sum does not fit in limbs"


class ExponentiationGate(Gate):
    """output = base^(sum_i 2^i bit_i): wire 0 the base, then the power
    bits (little-endian), the output, and one intermediate per bit, the
    square-and-multiply from the top bit down (reference
    exponentiation.rs:31-160)."""

    def __init__(self, num_power_bits: int,
                 spec: host.FieldSpec = host.GOLDILOCKS):
        self.num_power_bits = num_power_bits
        self.spec = spec

    @classmethod
    def from_config(cls, config, spec: host.FieldSpec = host.GOLDILOCKS):
        return cls(min(config.num_routed_wires - 2,
                       (config.num_wires - 2) // 2), spec)

    def id(self):
        """As the reference prints it (``{self:?}<D={D}>``).  The JAX
        package's id names the Goldilocks field and D = 2 over BabyBear
        too."""
        return (f"ExponentiationGate {{ num_power_bits: "
                f"{self.num_power_bits}, _phantom: PhantomData<"
                f"{FIELD_TYPE[self.spec.name]}> }}<D={self.spec.ext_degree}>")

    def wire_base(self):
        return 0

    def wire_power_bit(self, i):
        return 1 + i

    def wire_output(self):
        return 1 + self.num_power_bits

    def wire_intermediate_value(self, i):
        return 2 + self.num_power_bits + i

    def num_wires(self):
        return 2 + 2 * self.num_power_bits

    def num_constants(self):
        return 0

    def degree(self):
        return 4

    def num_constraints(self):
        return self.num_power_bits + 1

    def eval_unfiltered(self, A, vars):
        lw = vars.local_wires
        base = lw[self.wire_base()]
        nb = self.num_power_bits
        one = A.one()
        out = []
        for i in range(nb):
            prev = one if i == 0 else A.mul(
                lw[self.wire_intermediate_value(i - 1)],
                lw[self.wire_intermediate_value(i - 1)])
            bit = lw[self.wire_power_bit(nb - i - 1)]
            computed = A.mul(prev, A.add(A.mul(bit, base), A.sub(one, bit)))
            out.append(A.sub(computed, lw[self.wire_intermediate_value(i)]))
        out.append(A.sub(lw[self.wire_output()],
                         lw[self.wire_intermediate_value(nb - 1)]))
        return out

    def generators(self, row, local_constants, spec):
        return [_ExponentiationGenerator(self, row, spec)]


class _ExponentiationGenerator(gen.SimpleGenerator):
    """The intermediates and the output from the base and the bits."""

    def __init__(self, gate, row, spec):
        self.gate, self.row, self.spec = gate, row, spec

    def dependencies(self):
        g = self.gate
        return [tgt.wire(self.row, g.wire_base())] + [
            tgt.wire(self.row, g.wire_power_bit(i))
            for i in range(g.num_power_bits)]

    def run_once(self, witness, out):
        g, row, p = self.gate, self.row, self.spec.p
        base = witness.get_target(tgt.wire(row, g.wire_base()))
        nb = g.num_power_bits
        bits = [witness.get_target(tgt.wire(row, g.wire_power_bit(i)))
                for i in range(nb)]
        inter = 1
        for i in range(nb):
            bit = bits[nb - i - 1]
            inter = inter * inter % p * (bit * base + 1 - bit) % p
            out.append((tgt.wire(row, g.wire_intermediate_value(i)), inter))
        out.append((tgt.wire(row, g.wire_output()), inter))
