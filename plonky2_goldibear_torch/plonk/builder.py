"""Circuit builder (reference plonky2/src/plonk/circuit_builder.rs:144-1410,
gadgets/arithmetic.rs:30-165, gadgets/arithmetic_extension.rs,
gadgets/lookup.rs; the JAX package's ``plonk/builder.py``).

The builder is a host frontend: targets, gates placed row by row, copy
constraints and constants, base-field and extension arithmetic, lookup
tables and lookups, for the gates the port has (Arithmetic, AddMany,
Constant, PublicInput, Noop, Poseidon-GL, Poseidon2-BB width 16 and width
24 (the latter for a hashing gadget given ``hasher=hash.poseidon2_r0_bb``),
the two lookup gates, and the recursive verifier's: the extension
arithmetic, reducing, random-access, base-sum, coset-interpolation and
Poseidon MDS gates, placed by ``plonk/gadgets.py``).  ``build`` places
the lookup rows and, under a zero-knowledge config, the blinding rows, lays
out the selectors (the lookup selectors too), constants and sigmas,
commits the constants/sigmas on the device with the port's
``PolynomialBatch`` (the NTT, leaf-sponge and Merkle kernels on the card),
collects the witness generators and hashes the circuit digest;
``build_common`` lays out alone.  Cyclic recursion
(``recursion/conditional.py``) sets ``verifier_data_public_input`` and
``goal_common_data``, which the layout must meet.  The hasher is split in
two as in the reference's configs: ``hasher`` commits and runs the
transcript (the field's own, or ``hash.keccak_hasher`` for Goldilocks: the
Keccak config), ``inner_hasher`` (the field's own) serves every hashing
gadget and the public-input hash.  The streaming commit raises
``NotImplementedError`` naming its ROADMAP Queue 1 item.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import device as devmod
from ..field import host
from ..fri.oracle import PolynomialBatch
from ..gates import selectors as selectors_mod
from ..gates.basic_gates import (ArithmeticGate, ConstantGate, NoopGate,
                                 PublicInputGate)
from ..gates.extension_gates import ArithmeticExtensionGate, MulExtensionGate
from ..gates.lookup_gates import LookupGate, LookupTableGate
from ..gates.misc_gates import AddManyGate
from ..gates.poseidon import PoseidonGate
from ..gates.poseidon2_bb_gate import Poseidon2BabyBearGate
from ..hash import keccak_hasher
from ..iop import generator as gen
from ..iop import target as tgt
from ..utils.context_tree import ContextTree
from .circuit_data import (FIELDS, CircuitData, CommonCircuitData,
                           ProverOnlyCircuitData, VerifierOnlyCircuitData)
from .config import CircuitConfig
from .permutation import Forest
from .prover import phase


@dataclass
class GateInstance:
    gate: object
    constants: List[int]


def _hasher_name(hasher) -> str:
    return getattr(hasher, "__name__", repr(hasher))


def _digest_elements(digest) -> List[int]:
    """A digest as field elements (a byte digest's 7-byte chunks)."""
    if isinstance(digest, bytes):
        return keccak_hasher.digest_to_elements(digest)
    return list(digest)


def _not_ported(what: str, item):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class _ExtInverseGenerator(gen.SimpleGenerator):
    """1 / a for the division gadgets (reference
    gadgets/arithmetic_extension.rs QuotientGeneratorExtension)."""

    def __init__(self, a, inv_targets, spec):
        self.a = a
        self.inv_targets = inv_targets
        self.spec = spec

    def dependencies(self):
        return list(self.a)

    def run_once(self, witness, out):
        inv = host.ext_inv(self.spec,
                           tuple(witness.get_target(t) for t in self.a))
        out.extend(zip(self.inv_targets, inv))


class CircuitBuilder:
    def __init__(self, config: CircuitConfig,
                 spec: host.FieldSpec = host.GOLDILOCKS, hasher=None):
        self.config = config
        self.spec = spec
        _, self.F, self.inner_hasher = FIELDS[spec.name]
        self.hasher = self._commit_hasher(hasher)
        # the circuit digest's domain separator (circuit_builder.rs:1301)
        self.domain_separator: List[int] = []
        # cyclic recursion: the verifier data among the public inputs
        # (circuit_builder.rs:452) and the common data the circuit must
        # build to (circuit_builder.rs:1332)
        self.verifier_data_public_input = None
        self.goal_common_data = None
        self.gate_instances: List[GateInstance] = []
        self.gates: Dict[str, object] = {}
        self.copy_constraints: List[Tuple[tgt.Target, tgt.Target]] = []
        self.virtual_target_index = 0
        self.public_inputs: List[tgt.Target] = []
        self.constants_to_targets: Dict[int, tgt.Target] = {}
        self.targets_to_constants: Dict[tgt.Target, int] = {}
        self.constant_generators: List[gen.ConstantGenerator] = []
        self.generators: List = []
        # slot packing: gate id -> {params: (row, next free op)}
        # (circuit_builder.rs:824-853)
        self.current_slots: Dict[str, Dict[Tuple, Tuple[int, int]]] = {}
        self._slot_gates: Dict[str, object] = {}
        self.base_arithmetic_results: Dict[Tuple, tgt.Target] = {}
        self.ext_arithmetic_results: Dict[Tuple, Tuple] = {}
        # lookup tables, each table's (input, output) target pairs, and
        # each table's (last looking, last table, first table) rows
        # (circuit_builder.rs:194-197)
        self.luts: List[Tuple[Tuple[int, int], ...]] = []
        self.lut_to_lookups: List[List[Tuple]] = []
        self.lookup_rows: List[Tuple[int, int, int]] = []
        self.context_tree = ContextTree()

    def _commit_hasher(self, hasher):
        """The hasher that commits and runs the transcript: the field's
        own (None), or Keccak (the reference has a Keccak config over
        Goldilocks only)."""
        if hasher is None or hasher is self.inner_hasher:
            return self.inner_hasher
        name = _hasher_name(hasher)
        if getattr(hasher, "IN_CIRCUIT_ONLY", False):
            raise ValueError(f"{name} hashes in the circuit only: pass it "
                             "to a hashing gadget")
        if hasher is not keccak_hasher:
            raise ValueError(f"unknown hasher {name}")
        if self.spec.name != "goldilocks":
            raise ValueError(f"{name} has no config over {self.spec.name}")
        return hasher

    def _gadget_hasher(self, hasher):
        """The hasher of a hashing gadget: the inner hasher by default, or
        an in-circuit hasher of the builder's field (the width-24 Poseidon2
        over BabyBear).  Keccak is no algebraic hasher: no gate computes
        it."""
        if hasher is None or hasher is self.inner_hasher:
            return self.inner_hasher
        name = _hasher_name(hasher)
        if getattr(hasher, "IN_CIRCUIT_ONLY", False):
            if hasher.F.SPEC.name != self.spec.name:
                raise ValueError(f"{name} is a {hasher.F.SPEC.name} hasher")
            return hasher
        if hasher is keccak_hasher:
            raise ValueError(f"{name} is not algebraic: it cannot hash in "
                             "the circuit")
        raise ValueError(f"unknown hasher {name}")

    # -- targets -------------------------------------------------------------

    def add_virtual_target(self) -> tgt.Target:
        t = tgt.virtual_target(self.virtual_target_index)
        self.virtual_target_index += 1
        return t

    def add_virtual_targets(self, n: int) -> List[tgt.Target]:
        return [self.add_virtual_target() for _ in range(n)]

    def register_public_input(self, t: tgt.Target):
        self.public_inputs.append(t)

    def register_public_inputs(self, ts: Sequence[tgt.Target]):
        for t in ts:
            self.register_public_input(t)

    def num_gates(self) -> int:
        return len(self.gate_instances)

    # -- gate-count contexts (circuit_builder.rs:719-725) --------------------

    def push_context(self, name: str):
        self.context_tree.push(name, self.num_gates())

    def pop_context(self):
        self.context_tree.pop(self.num_gates())

    def print_gate_counts(self, min_delta: int = 1) -> str:
        """The gate count of each context (context_tree.rs:134,
        circuit_builder.rs:1042-1058); returns the report and logs it."""
        final = self.num_gates()
        report = "\n".join(self.context_tree.filter(final, min_delta)
                           .lines(final))
        logging.getLogger(__name__).debug(report)
        return report

    # -- gates ---------------------------------------------------------------

    def add_gate(self, gate, constants: Sequence[int]) -> int:
        assert gate.num_wires() <= self.config.num_wires, \
            f"{gate.id()} needs {gate.num_wires()} wires"
        assert gate.num_constants() <= self.config.num_constants or \
            isinstance(gate, ConstantGate), gate.id()
        constants = [c % self.spec.p for c in constants]
        assert len(constants) <= gate.num_constants(), "Too many constants."
        constants = constants + [0] * (gate.num_constants() - len(constants))
        row = len(self.gate_instances)
        for ci, wi in gate.extra_constant_wires():
            self.constant_generators.append(
                gen.ConstantGenerator(row, ci, wi, 0))
        self.gates[gate.id()] = gate
        self.gate_instances.append(GateInstance(gate, constants))
        return row

    def add_gate_to_gate_set(self, gate):
        """A gate in the circuit's gate set without a row
        (circuit_builder.rs:533-537)."""
        self.gates[gate.id()] = gate

    def find_slot(self, gate, params: Sequence[int],
                  constants: Sequence[int]) -> Tuple[int, int]:
        """(row, op) of a free op of a ``gate`` row with these params
        (circuit_builder.rs:824-853)."""
        num_gates = self.num_gates()
        self._slot_gates[gate.id()] = gate
        slots = self.current_slots.setdefault(gate.id(), {})
        key = tuple(int(x) % self.spec.p for x in params)
        if key in slots:
            gate_idx, slot_idx = slots[key]
        else:
            self.add_gate(gate, list(constants))
            gate_idx, slot_idx = num_gates, 0
        if slot_idx == gate.num_ops - 1:
            slots.pop(key, None)
        else:
            slots[key] = (gate_idx, slot_idx + 1)
        return gate_idx, slot_idx

    # -- copy constraints and constants --------------------------------------

    def connect(self, x: tgt.Target, y: tgt.Target):
        assert tgt.is_routable(x, self.config.num_routed_wires), x
        assert tgt.is_routable(y, self.config.num_routed_wires), y
        self.copy_constraints.append((x, y))

    def assert_equal(self, x, y):
        self.connect(x, y)

    def constant(self, c: int) -> tgt.Target:
        c %= self.spec.p
        if c in self.constants_to_targets:
            return self.constants_to_targets[c]
        t = self.add_virtual_target()
        self.constants_to_targets[c] = t
        self.targets_to_constants[t] = c
        return t

    def constants(self, cs: Sequence[int]) -> List[tgt.Target]:
        return [self.constant(c) for c in cs]

    def zero(self) -> tgt.Target:
        return self.constant(0)

    def one(self) -> tgt.Target:
        return self.constant(1)

    def two(self) -> tgt.Target:
        return self.constant(2)

    def neg_one(self) -> tgt.Target:
        return self.constant(self.spec.p - 1)

    def target_as_constant(self, t: tgt.Target) -> Optional[int]:
        return self.targets_to_constants.get(t)

    def add_simple_generator(self, g):
        self.generators.append(g)

    def generate_copy(self, src, dst):
        self.add_simple_generator(gen.CopyGenerator(src, dst))

    # -- arithmetic gadget (gadgets/arithmetic.rs) ---------------------------

    def arithmetic(self, const_0: int, const_1: int, m0: tgt.Target,
                   m1: tgt.Target, addend: tgt.Target) -> tgt.Target:
        """const_0 * m0 * m1 + const_1 * addend."""
        p = self.spec.p
        const_0 %= p
        const_1 %= p
        special = self._arithmetic_special_cases(const_0, const_1, m0, m1,
                                                 addend)
        if special is not None:
            return special
        op = (const_0, const_1, m0, m1, addend)
        if op in self.base_arithmetic_results:
            return self.base_arithmetic_results[op]
        result = self._add_base_arithmetic_operation(op)
        self.base_arithmetic_results[op] = result
        return result

    def _arithmetic_special_cases(self, c0, c1, m0, m1, addend):
        p = self.spec.p
        # zero() places the 0 constant even when no case applies: the
        # circuit (and its digest) has it whenever arithmetic is called
        zero = self.zero()
        mc0 = self.target_as_constant(m0)
        mc1 = self.target_as_constant(m1)
        ac = self.target_as_constant(addend)
        first_zero = c0 == 0 or m0 == zero or m1 == zero
        second_zero = c1 == 0 or addend == zero
        first_const = 0 if first_zero else (
            mc0 * mc1 % p * c0 % p if (mc0 is not None and mc1 is not None)
            else None)
        second_const = 0 if second_zero else (
            ac * c1 % p if ac is not None else None)
        if first_const is not None and second_const is not None:
            return self.constant((first_const + second_const) % p)
        if first_zero and c1 == 1:
            return addend
        if second_zero:
            if mc0 is not None and mc0 * c0 % p == 1:
                return m1
            if mc1 is not None and mc1 * c0 % p == 1:
                return m0
        return None

    def _add_base_arithmetic_operation(self, op) -> tgt.Target:
        c0, c1, m0, m1, addend = op
        gate = ArithmeticGate.from_config(self.config)
        row, i = self.find_slot(gate, [c0, c1], [c0, c1])
        w0, w1, wa, wo = ArithmeticGate.wires(i)
        self.connect(m0, tgt.wire(row, w0))
        self.connect(m1, tgt.wire(row, w1))
        self.connect(addend, tgt.wire(row, wa))
        return tgt.wire(row, wo)

    def add(self, x, y):
        # 1 * x * 1 + 1 * y (arithmetic.rs:197-202)
        return self.arithmetic(1, 1, x, self.one(), y)

    def sub(self, x, y):
        return self.arithmetic(1, self.spec.p - 1, x, self.one(), y)

    def mul(self, x, y):
        # 1 * x * y + 0 * x: the addend is x, not zero (arithmetic.rs:
        # 244-247), and the wiring is part of the digest
        return self.arithmetic(1, 0, x, y, x)

    def mul_add(self, x, y, z):
        return self.arithmetic(1, 1, x, y, z)

    def mul_sub(self, x, y, z):
        return self.arithmetic(1, self.spec.p - 1, x, y, z)

    def mul_const(self, c, x):
        # routes a constant target (arithmetic.rs:180-183)
        return self.mul(self.constant(c), x)

    def mul_const_add(self, c, x, y):
        return self.mul_add(self.constant(c), x, y)

    def add_const(self, x, c):
        return self.add(x, self.constant(c))

    def square(self, x):
        return self.mul(x, x)

    def cube(self, x):
        return self.mul_many([x, x, x])

    # exactly this many addends go to one AddManyGate op (arithmetic.rs:23)
    ADD_MANY_THRESHOLD = 23

    def add_many(self, xs):
        """The sum of ``xs`` (arithmetic.rs:215-238): a chain of ``add``
        below the threshold, one AddManyGate op at it, and above it the
        sum of the sums of chunks of the threshold's size."""
        addends = list(xs)
        n = len(addends)
        if n < self.ADD_MANY_THRESHOLD:
            out = self.zero()
            for x in addends:
                out = self.add(out, x)
            return out
        if n > self.ADD_MANY_THRESHOLD:
            return self.add_many([
                self.add_many(addends[k:k + self.ADD_MANY_THRESHOLD])
                for k in range(0, n, self.ADD_MANY_THRESHOLD)])
        gate = AddManyGate.from_config(self.config, n)
        row, op = self.find_slot(gate, [], [])
        for t, w in zip(addends, gate.wires_addends(op)):
            self.connect(t, tgt.wire(row, w))
        return tgt.wire(row, gate.wire_sum(op))

    def mul_many(self, xs):
        out = self.one()
        for x in xs:
            out = self.mul(out, x)
        return out

    def assert_zero(self, x):
        self.connect(x, self.zero())

    def assert_one(self, x):
        self.connect(x, self.one())

    # -- extension arithmetic (gadgets/arithmetic_extension.rs,
    #    iop/ext_target.rs): an extension target is a tuple of D targets ----

    @property
    def D(self) -> int:
        return self.spec.ext_degree

    def add_virtual_extension_target(self) -> Tuple[tgt.Target, ...]:
        return tuple(self.add_virtual_target() for _ in range(self.D))

    def add_virtual_extension_targets(self, n: int):
        return [self.add_virtual_extension_target() for _ in range(n)]

    def constant_extension(self, coeffs) -> Tuple[tgt.Target, ...]:
        if isinstance(coeffs, int):
            coeffs = (coeffs,) + (0,) * (self.D - 1)
        assert len(coeffs) == self.D
        return tuple(self.constant(c) for c in coeffs)

    def zero_extension(self):
        return self.constant_extension(0)

    def one_extension(self):
        return self.constant_extension(1)

    def convert_to_ext(self, t: tgt.Target) -> Tuple[tgt.Target, ...]:
        return (t,) + (self.zero(),) * (self.D - 1)

    def connect_extension(self, a, b):
        for x, y in zip(a, b):
            self.connect(x, y)

    def target_as_constant_ext(self, a) -> Optional[Tuple[int, ...]]:
        cs = tuple(self.target_as_constant(t) for t in a)
        return None if any(c is None for c in cs) else cs

    def arithmetic_extension(self, const_0: int, const_1: int, m0, m1,
                             addend) -> Tuple[tgt.Target, ...]:
        """const_0 * m0 * m1 + const_1 * addend over the extension
        (arithmetic_extension.rs:27-115): the special cases first, then a
        cache of whole operations, then an op of a MulExtensionGate row when
        the addend is the zero constant, else of an ArithmeticExtensionGate
        row with these constants."""
        p = self.spec.p
        const_0 %= p
        const_1 %= p
        special = self._arithmetic_extension_special_cases(
            const_0, const_1, m0, m1, addend)
        if special is not None:
            return special
        op = (const_0, const_1, m0, m1, addend)
        if op in self.ext_arithmetic_results:
            return self.ext_arithmetic_results[op]
        if self.target_as_constant_ext(addend) == (0,) * self.D:
            gate = MulExtensionGate.from_config(self.config, self.D)
            row, i = self.find_slot(gate, [const_0], [const_0])
            inputs = (m0, m1)
        else:
            gate = ArithmeticExtensionGate.from_config(self.config, self.D)
            row, i = self.find_slot(gate, [const_0, const_1],
                                    [const_0, const_1])
            inputs = (m0, m1, addend)
        wires = gate.wires_op(i)
        for ts, ws in zip(inputs, wires):
            for t, w in zip(ts, ws):
                self.connect(t, tgt.wire(row, w))
        result = tuple(tgt.wire(row, w) for w in wires[-1])
        self.ext_arithmetic_results[op] = result
        return result

    def _arithmetic_extension_special_cases(self, const_0, const_1, m0, m1,
                                            addend):
        """arithmetic_extension.rs:117-171."""
        spec = self.spec
        zero = self.zero_extension()
        mc0 = self.target_as_constant_ext(m0)
        mc1 = self.target_as_constant_ext(m1)
        ac = self.target_as_constant_ext(addend)
        first_zero = const_0 == 0 or m0 == zero or m1 == zero
        second_zero = const_1 == 0 or addend == zero
        zero_v = (0,) * self.D
        first_const = zero_v if first_zero else (
            host.ext_scalar_mul(spec, host.ext_mul(spec, mc0, mc1), const_0)
            if mc0 is not None and mc1 is not None else None)
        second_const = zero_v if second_zero else (
            host.ext_scalar_mul(spec, ac, const_1) if ac is not None
            else None)
        if first_const is not None and second_const is not None:
            return self.constant_extension(
                host.ext_add(spec, first_const, second_const))
        if first_zero and const_1 == 1:
            return addend
        if second_zero:
            one_v = host.ext_one(spec)
            if mc0 is not None and \
                    host.ext_scalar_mul(spec, mc0, const_0) == one_v:
                return m1
            if mc1 is not None and \
                    host.ext_scalar_mul(spec, mc1, const_0) == one_v:
                return m0
        return None

    def mul_extension_with_const(self, const_0: int, m0, m1):
        return self.arithmetic_extension(const_0, 0, m0, m1,
                                         self.zero_extension())

    def add_extension(self, a, b):
        # 1 * one * a + 1 * b: the multiplicands are (one, a)
        # (arithmetic_extension.rs:199-206), and the wiring is in the digest
        return self.arithmetic_extension(1, 1, self.one_extension(), a, b)

    def sub_extension(self, a, b):
        return self.arithmetic_extension(1, self.spec.p - 1,
                                         self.one_extension(), a, b)

    def mul_extension(self, a, b):
        return self.mul_extension_with_const(1, a, b)

    def square_extension(self, a):
        return self.mul_extension(a, a)

    def cube_extension(self, a):
        return self.mul_many_extension([a, a, a])

    def mul_add_extension(self, a, b, c):
        return self.arithmetic_extension(1, 1, a, b, c)

    def mul_sub_extension(self, a, b, c):
        return self.arithmetic_extension(1, self.spec.p - 1, a, b, c)

    def mul_const_extension(self, c: int, a):
        # routes a constant target (arithmetic_extension.rs:350-353)
        return self.mul_extension(self.constant_extension(c), a)

    def mul_const_add_extension(self, c: int, a, b):
        return self.mul_add_extension(self.constant_extension(c), a, b)

    def add_const_extension(self, a, c: int):
        return self.add_extension(a, self.constant_extension(c))

    def scalar_mul_ext(self, s: tgt.Target, a):
        """A base target times an extension target."""
        return self.mul_extension(self.convert_to_ext(s), a)

    def scalar_mul_add_extension(self, s: tgt.Target, b, c):
        return self.arithmetic_extension(1, 1, self.convert_to_ext(s), b, c)

    def scalar_mul_sub_extension(self, s: tgt.Target, b, c):
        return self.arithmetic_extension(1, self.spec.p - 1,
                                         self.convert_to_ext(s), b, c)

    def add_many_extension(self, terms):
        acc = self.zero_extension()
        for t in terms:
            acc = self.add_extension(acc, t)
        return acc

    def mul_many_extension(self, terms):
        acc = self.one_extension()
        for t in terms:
            acc = self.mul_extension(acc, t)
        return acc

    def exp_u64_extension(self, base, exponent: int):
        """base^e for an exponent known on the host
        (arithmetic_extension.rs:442-467: the small exponents, then square
        and multiply from the least significant bit)."""
        if exponent == 0:
            return self.one_extension()
        if exponent == 1:
            return base
        if exponent == 2:
            return self.square_extension(base)
        if exponent == 3:
            return self.cube_extension(base)
        result = self.one_extension()
        while exponent:
            if exponent & 1:
                result = self.mul_extension(result, base)
            exponent >>= 1
            if exponent:
                base = self.square_extension(base)
        return result

    def div_add_extension(self, x, y, z):
        """x / y + z: a witnessed inverse of y, the check y * inv = 1, then
        one mul_add (arithmetic_extension.rs:479-498)."""
        inv = self.add_virtual_extension_target()
        self.add_simple_generator(_ExtInverseGenerator(y, inv, self.spec))
        self.connect_extension(self.mul_extension(y, inv),
                               self.one_extension())
        return self.mul_add_extension(x, inv, z)

    def div_extension(self, a, b):
        return self.div_add_extension(a, b, self.zero_extension())

    def inverse_extension(self, a):
        return self.div_extension(self.one_extension(), a)

    # -- lookups (gadgets/lookup.rs:54-160, circuit_builder.rs:744-819) -----

    def add_lookup_table_from_pairs(self, pairs) -> int:
        """The index of the table of (input, output) u16 pairs, registered
        once."""
        lut = tuple((int(i) & 0xFFFF, int(o) & 0xFFFF) for i, o in pairs)
        if lut in self.luts:
            return self.luts.index(lut)
        self.luts.append(lut)
        self.lut_to_lookups.append([])
        return len(self.luts) - 1

    def add_lookup_table_from_table(self, inputs, outputs) -> int:
        return self.add_lookup_table_from_pairs(list(zip(inputs, outputs)))

    def add_lookup_table_from_fn(self, f, inputs) -> int:
        return self.add_lookup_table_from_pairs([(i, f(i)) for i in inputs])

    def add_lookup_from_index(self, looking_in: tgt.Target,
                              lut_index: int) -> tgt.Target:
        """The output target of a lookup of ``looking_in`` in a registered
        table; its row is placed at ``build``."""
        assert lut_index < len(self.luts), "unknown lookup table"
        looking_out = self.add_virtual_target()
        self.lut_to_lookups[lut_index].append((looking_in, looking_out))
        return looking_out

    def _add_all_lookups(self):
        """Each table's LookupGate rows (the last one slot-packed), its
        LookupTableGate rows, then a NoopGate (gadgets/lookup.rs:83-157):
        the rows are upside down, so a transition constraint reads this
        row and the next, and the all-zero Noop row makes the initial
        constraints plain zero checks."""
        for lut_index, lut in enumerate(self.luts):
            lookups = self.lut_to_lookups[lut_index]
            assert lookups, f"LUT {lut_index} is unused"
            last_lu_gate = self.num_gates()
            gate = LookupGate.from_config(self.config, lut)
            slots = gate.num_slots
            full = len(lookups) // slots
            for c in range(full):
                row = self.add_gate(gate, [])
                for i, (lin, lout) in enumerate(
                        lookups[c * slots:(c + 1) * slots]):
                    self.connect(lin, tgt.wire(
                        row, LookupGate.wire_ith_looking_inp(i)))
                    self.connect(lout, tgt.wire(
                        row, LookupGate.wire_ith_looking_out(i)))
            for lin, lout in lookups[full * slots:]:
                row, i = self.find_slot(gate, [lut_index], [])
                self.connect(lin, tgt.wire(
                    row, LookupGate.wire_ith_looking_inp(i)))
                self.connect(lout, tgt.wire(
                    row, LookupGate.wire_ith_looking_out(i)))

            last_lut_gate = self.num_gates()
            entries = LookupTableGate.num_slots_of(self.config)
            tgate = LookupTableGate(entries, lut, last_lut_gate)
            for _ in range((len(lut) - 1) // entries + 1):
                self.add_gate(tgate, [])
            first_lut_gate = self.num_gates() - 1
            self.add_gate(NoopGate(), [])
            self.lookup_rows.append((last_lu_gate, last_lut_gate,
                                     first_lut_gate))

    # -- zero knowledge (circuit_builder.rs:873-980) -------------------------

    def _num_blinding_gates(self, degree_estimate: int) -> Tuple[int, int]:
        """(regular, Z-pair) blinding rows for a degree estimate: one a
        value that the openings and FRI queries reveal
        (circuit_builder.rs:873-898)."""
        D = self.spec.ext_degree
        params = self.config.fri_config.fri_params(
            host.log2_strict(degree_estimate), True)
        arities = [1 << a for a in params.reduction_arity_bits]
        prod = 1
        for a in arities:
            prod *= a
        fri_openings = self.config.fri_config.num_query_rounds * (
            1 + D * sum(a - 1 for a in arities)
            + D * (degree_estimate // prod))
        return D + fri_openings, 2 * D + fri_openings

    def _blinding_counts(self) -> Tuple[int, int]:
        """The blinding rows at the least power-of-two degree that holds
        the rows and them (circuit_builder.rs:903-922)."""
        num_gates = len(self.gate_instances)
        degree_estimate = 1 << host.log2_ceil(max(num_gates, 2))
        while True:
            regular, z = self._num_blinding_gates(degree_estimate)
            if num_gates + regular + 2 * z <= degree_estimate:
                return regular, z
            degree_estimate *= 2

    def _blind(self):
        """A row of random wires for each regular opening; for each Z
        opening two rows whose routed wires are random and copied from the
        first to the second (circuit_builder.rs:924-980)."""
        regular, z_openings = self._blinding_counts()
        p = self.spec.p
        config = self.config
        for _ in range(regular):
            row = self.add_gate(NoopGate(), [])
            self.add_simple_generator(gen.RandomRowGenerator(
                row, range(config.num_wires), p))
        for _ in range(z_openings):
            row1 = self.add_gate(NoopGate(), [])
            row2 = self.add_gate(NoopGate(), [])
            self.add_simple_generator(gen.RandomRowGenerator(
                row1, range(config.num_routed_wires), p))
            for w in range(config.num_routed_wires):
                self.generate_copy(tgt.wire(row1, w), tgt.wire(row2, w))
                self.connect(tgt.wire(row1, w), tgt.wire(row2, w))

    # -- hashing gadgets (plonk/config.rs:97-166) ----------------------------

    def permute_swapped(self, state: Sequence[tgt.Target], swap: tgt.Target,
                        hasher=None) -> List[tgt.Target]:
        """One permutation-gate op: permute ``state``, the first two
        digest-size chunks swapped when ``swap`` is 1 (Poseidon width 12
        for Goldilocks, Poseidon2 width 16 for BabyBear, or the width-24
        Poseidon2 ``hasher``)."""
        hasher = self._gadget_hasher(hasher)
        if hasher is not self.inner_hasher:
            g = hasher.permutation_gate(self.config)
        elif self.spec.name == "goldilocks":
            g = PoseidonGate()
            row = self.add_gate(g, [])
            self.connect(swap, tgt.wire(row, PoseidonGate.WIRE_SWAP))
            for i, s in enumerate(state):
                self.connect(s, tgt.wire(row, PoseidonGate.wire_input(i)))
            return [tgt.wire(row, PoseidonGate.wire_output(i))
                    for i in range(len(state))]
        else:
            g = Poseidon2BabyBearGate.from_config(self.config)
        row, op = self.find_slot(g, [], [])
        self.connect(swap, tgt.wire(row, g.wire_swap(op)))
        for i, s in enumerate(state):
            self.connect(s, tgt.wire(row, g.wire_input(op, i)))
        return [tgt.wire(row, g.wire_output(op, i))
                for i in range(len(state))]

    def permute(self, state: Sequence[tgt.Target],
                hasher=None) -> List[tgt.Target]:
        return self.permute_swapped(state, self.zero(), hasher)

    def hash_n_to_m_no_pad(self, inputs: Sequence[tgt.Target],
                           num_outputs: int,
                           hasher=None) -> List[tgt.Target]:
        """The overwrite-mode sponge in the circuit (config.rs:135-166);
        the width-24 sponge zero-fills a short chunk to the rate
        (poseidon2_risc0_babybear.rs:249-254)."""
        hasher = self._gadget_hasher(hasher)
        rate, width = hasher.RATE, hasher.WIDTH
        state = [self.zero()] * width
        for i in range(0, len(inputs), rate):
            chunk = list(inputs[i:i + rate])
            if getattr(hasher, "ZERO_FILL", False):
                chunk += [self.zero()] * (rate - len(chunk))
            state = chunk + state[len(chunk):]
            state = self.permute(state, hasher)
        outputs: List[tgt.Target] = []
        while True:
            for s in state[:rate]:
                outputs.append(s)
                if len(outputs) == num_outputs:
                    return outputs
            state = self.permute(state, hasher)

    def hash_n_to_hash_no_pad(self, inputs: Sequence[tgt.Target],
                              hasher=None) -> List[tgt.Target]:
        return self.hash_n_to_m_no_pad(inputs, self.spec.num_hash_out_elts,
                                       hasher)

    def hash_or_noop(self, inputs: Sequence[tgt.Target],
                     hasher=None) -> List[tgt.Target]:
        n = self.spec.num_hash_out_elts
        if len(inputs) <= n:
            return list(inputs) + [self.zero()] * (n - len(inputs))
        return self.hash_n_to_hash_no_pad(inputs, hasher)

    # -- build (circuit_builder.rs:1110-1360) --------------------------------

    def build(self, device=None, timings: Optional[Dict[str, float]] = None,
              commit_streaming: bool = False) -> CircuitData:
        """Lay out, commit and index the circuit on ``device`` (the card
        unless the caller asks for the CPU).  ``timings`` gets the seconds
        of ``gates_and_routing``, ``sigmas``, ``commit`` and ``digest``.
        Raises ``ValueError`` when ``goal_common_data`` is set and the
        circuit's common data differs from it."""
        dev = devmod.resolve(device)
        config = self.config
        if commit_streaming:
            raise _not_ported("the streaming commit", 9)
        spec = self.spec
        rate_bits = config.fri_config.rate_bits
        cap_height = config.fri_config.cap_height

        with phase(timings, "gates_and_routing", dev):
            common, random_wire, constant_vecs = self._lay_out()

        with phase(timings, "sigmas", dev):
            subgroup = host.two_adic_subgroup(spec, common.degree_bits)
            sigma_vecs, forest = self._sigma_vecs(common.k_is, subgroup)
            constants_sigmas = np.stack(
                [np.asarray(v, dtype=np.uint64) for v in constant_vecs]
                + list(sigma_vecs))

            # the gate generators, less the unused ops of slot gates
            # (circuit_builder.rs:1252-1267)
            incomplete = {}
            for slots in self.current_slots.values():
                for gate_idx, op in slots.values():
                    incomplete[gate_idx] = op
            for row, inst in enumerate(self.gate_instances):
                gens = inst.gate.generators(row, inst.constants, spec)
                if row in incomplete:
                    gens = gens[:incomplete[row]]
                self.generators.extend(gens)

            # the generators watching each representative, each once, in
            # list order
            by_watches: Dict[int, List[int]] = {}
            parents = forest.parents
            for i, g in enumerate(self.generators):
                for watch in g.watch_list():
                    rep = int(parents[forest.target_index(watch)])
                    watchers = by_watches.setdefault(rep, [])
                    if i not in watchers[-1:]:
                        watchers.append(i)

        with phase(timings, "commit", dev):
            cs_values = self.F.from_ints(constants_sigmas, dev)
            commitment = PolynomialBatch.from_values(
                cs_values, rate_bits, cap_height, self.F, self.hasher)
            cap = commitment.cap_host()

        with phase(timings, "digest", dev):
            # cap, the domain separator's hash and degree_bits
            # (circuit_builder.rs:1300-1320), byte digests as elements
            circuit_digest = self.hasher.hash_no_pad_host(
                [x for row in cap for x in _digest_elements(row)]
                + _digest_elements(self._hash_pad(self.domain_separator))
                + [common.degree_bits])

        prover_only = ProverOnlyCircuitData(
            generators=self.generators,
            generator_indices_by_watches=by_watches,
            constants_sigmas_values=cs_values,
            constants_sigmas_commitment=commitment,
            public_inputs=self.public_inputs,
            representative_map=forest.parents,
            circuit_digest=circuit_digest, random_wire=random_wire,
            lookup_rows=list(self.lookup_rows),
            lut_to_lookups=[list(v) for v in self.lut_to_lookups])
        verifier_only = VerifierOnlyCircuitData(
            constants_sigmas_cap=cap, circuit_digest=circuit_digest)
        return CircuitData(common=common, prover_only=prover_only,
                           verifier_only=verifier_only, device=dev,
                           F=self.F, hasher=self.hasher,
                           inner_hasher=self.inner_hasher)

    def build_common(self) -> CommonCircuitData:
        """The common data that ``build`` gives, without the sigmas, the
        generators or the commit: the rows are laid out (the builder is
        spent, as after ``build``) and checked against
        ``goal_common_data``.  The fixed point of cyclic recursion
        (``recursion/conditional.py:common_data_for_recursion``) needs no
        more."""
        return self._lay_out()[0]

    def _lay_out(self):
        """The public-input hash and gate, the completed slots, the lookup
        rows, the random wire, the constant gates, the blinding rows and
        the padding (circuit_builder.rs:1064-1180), then the selectors and
        the common data (circuit_builder.rs:1180-1300), checked against
        ``goal_common_data`` (circuit_builder.rs:1332).  Returns (common
        data, the random wire, the constant columns)."""
        config = self.config
        zk = config.zero_knowledge
        spec = self.spec
        p = spec.p
        num_public_inputs = len(self.public_inputs)
        # the public inputs hashed in the circuit (circuit_builder.rs:
        # 1129-1139); no inputs squeeze the zero state, no gates
        pi_hash_targets = self.hash_n_to_m_no_pad(
            self.public_inputs, spec.num_hash_out_elts)
        pi_gate = self.add_gate(PublicInputGate(spec.num_hash_out_elts), [])
        for i, t in enumerate(pi_hash_targets):
            self.connect(t, tgt.wire(pi_gate, i))

        # complete the partly used slot gates that zeros do not satisfy
        # (circuit_builder.rs:1082)
        for gate_id, slots in list(self.current_slots.items()):
            gate = self._slot_gates[gate_id]
            for params, (gate_idx, slot_idx) in list(slots.items()):
                if gate.complete_wires(self, gate_idx, slot_idx):
                    slots.pop(params, None)

        # the lookup rows (circuit_builder.rs:1142)
        self._add_all_lookups()

        # anti-#456 randomization (circuit_builder.rs:1064-1080)
        random_wire = None
        for w in range(spec.num_hash_out_elts, config.num_wires):
            if w == config.num_wires - 1:
                random_wire = (pi_gate, w)
            self.add_simple_generator(
                gen.RandomValueGenerator(tgt.wire(pi_gate, w), p))

        # constant gates and their routing (circuit_builder.rs:1145-1172)
        while len(self.constants_to_targets) > len(self.constant_generators):
            self.add_gate(ConstantGate(config.num_constants), [])
        pairs = sorted(self.constants_to_targets.items(),
                       key=lambda kv: kv[0])
        for (c, t), cg in zip(pairs, self.constant_generators):
            self.gate_instances[cg.row].constants[cg.constant_index] = c
            self.connect(tgt.wire(cg.row, cg.wire_index), t)
            cg.constant = c
            self.add_simple_generator(cg)

        # blind, then pad to a power of two (circuit_builder.rs:924-980)
        if zk:
            self._blind()
        while len(self.gate_instances) & (len(self.gate_instances) - 1):
            self.add_gate(NoopGate(), [])

        degree = len(self.gate_instances)
        degree_bits = host.log2_strict(degree)
        fri_params = config.fri_config.fri_params(degree_bits, zk)
        assert fri_params.total_arities() <= \
            degree_bits + config.fri_config.rate_bits \
            - config.fri_config.cap_height, \
            "FRI total reduction arity is too large."

        quotient_degree_factor = config.max_quotient_degree_factor
        gates = sorted(self.gates.values(), key=lambda g: (g.degree(), g.id()))
        selector_polys, selectors_info = selectors_mod.selector_polynomials(
            gates, self.gate_instances, quotient_degree_factor + 1, p)
        lookup_selectors = []
        if self.luts:
            lookup_selectors = selectors_mod.selectors_lookup(
                degree, self.lookup_rows) + \
                selectors_mod.selector_ends_lookups(degree, self.lookup_rows)
        constant_vecs = (list(selector_polys) + lookup_selectors
                         + self._constant_polys(gates))

        common = CommonCircuitData(
            config=config, fri_params=fri_params, gates=gates,
            selectors_info=selectors_info,
            quotient_degree_factor=quotient_degree_factor,
            num_gate_constraints=max(g.num_constraints() for g in gates),
            num_constants=len(constant_vecs),
            num_public_inputs=num_public_inputs,
            k_is=host.get_unique_coset_shifts(spec, degree,
                                              config.num_routed_wires),
            num_partial_products=(
                -(-config.num_routed_wires // quotient_degree_factor) - 1),
            spec=spec,
            # 1 running sum + the partial sums of the looking slots
            # (circuit_builder.rs:1290-1299)
            num_lookup_polys=1 + -(-LookupGate.num_slots_of(config)
                                   // (quotient_degree_factor - 1))
            if self.luts else 0,
            num_lookup_selectors=len(lookup_selectors),
            luts=list(self.luts))
        if self.goal_common_data is not None and \
                common != self.goal_common_data:
            raise ValueError("the built common data differs from "
                             "goal_common_data")
        return common, random_wire, constant_vecs

    def _hash_pad(self, inputs: List[int]):
        """pad10*1, then hash (plonk/config.rs:58-66)."""
        padded = list(inputs) + [1]
        rate = self.hasher.RATE
        while (len(padded) + 1) % rate != 0:
            padded.append(0)
        padded.append(1)
        return self.hasher.hash_no_pad_host(padded)

    def _constant_polys(self, gates) -> List[np.ndarray]:
        max_constants = max(g.num_constants() for g in gates)
        mat = np.zeros((max_constants, len(self.gate_instances)),
                       dtype=np.uint64)
        for row, inst in enumerate(self.gate_instances):
            for i, c in enumerate(inst.constants):
                mat[i, row] = c
        return list(mat)

    def _sigma_vecs(self, k_is, subgroup):
        config = self.config
        degree = len(self.gate_instances)
        forest = Forest(config.num_wires, config.num_routed_wires, degree,
                        self.virtual_target_index)
        for a, b in self.copy_constraints:
            forest.merge(a, b)
        forest.compress_paths()
        wp = forest.wire_partition()
        return (wp.get_sigma_polys(host.log2_strict(degree), k_is, subgroup,
                                   self.spec.p), forest)
