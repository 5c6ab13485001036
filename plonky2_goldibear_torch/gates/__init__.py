"""Gates, constraint side, and the id strings the port accepts (a lookup
gate's id carries its table's hash: ``gate_from_id`` finds the table among
the circuit's ``luts``)."""

import re

from ..field import host
from .access_gates import (BaseSumGate, ExponentiationGate,
                           RandomAccessGate)
from .base import Gate
from .basic_gates import ArithmeticGate, ConstantGate, NoopGate, \
    PublicInputGate
from .coset_interpolation import CosetInterpolationGate
from .extension_gates import ArithmeticExtensionGate, MulExtensionGate
from .lookup_gates import LookupGate, LookupTableGate, lut_hash
from .misc_gates import (AddManyGate, ApplyMat4Gate,
                         Poseidon2InternalPermutationGate)
from .poseidon import PoseidonGate
from .poseidon2_bb_gate import Poseidon2BabyBearGate
from .poseidon2_r0_bb_gate import Poseidon2R0BabyBearGate
from .poseidon_mds import PoseidonMdsGate
from .reducing import ReducingExtensionGate, ReducingGate

# (id pattern, gate of the match and the field spec)
_PATTERNS = [
    (r"ArithmeticGate \{ num_ops: (\d+) \}",
     lambda m, s: ArithmeticGate(int(m[1]))),
    (r"ConstantGate \{ num_consts: (\d+) \}",
     lambda m, s: ConstantGate(int(m[1]))),
    (r"PublicInputGate<(\d+)>", lambda m, s: PublicInputGate(int(m[1]))),
    (r"NoopGate", lambda m, s: NoopGate()),
    (r"PoseidonGate<WIDTH=12>", lambda m, s: PoseidonGate()),
    (r"Poseidon2BabyBearGate \{ num_ops: (\d+), _phantom: "
     r"PhantomData<p3_baby_bear::baby_bear::BabyBear> \}<WIDTH=16>",
     lambda m, s: Poseidon2BabyBearGate(int(m[1]))),
    (r"Poseidon2R0BabyBearGate \{ num_ops: (\d+), _phantom: "
     r"PhantomData<p3_baby_bear::baby_bear::BabyBear> \}<WIDTH=24>",
     lambda m, s: Poseidon2R0BabyBearGate(int(m[1]))),
    (r"AddManyGate \{ num_addends: (\d+), num_ops: (\d+) \}",
     lambda m, s: AddManyGate(int(m[1]), int(m[2]))),
    (r"ApplyMat4Gate \{ num_ops: (\d+), _phantom: "
     r"PhantomData<p3_baby_bear::baby_bear::BabyBear> \}<D=(\d+)>",
     lambda m, s: ApplyMat4Gate(int(m[1]), int(m[2]))),
    (r"Poseidon2InternalPermutationGate \{ _phantom: "
     r"PhantomData<p3_baby_bear::baby_bear::BabyBear> \}<D=(\d+)>",
     lambda m, s: Poseidon2InternalPermutationGate(int(m[1]))),
    (r"ArithmeticExtensionGate \{ num_ops: (\d+) \}",
     lambda m, s: ArithmeticExtensionGate(int(m[1]), s.ext_degree)),
    (r"MulExtensionGate \{ num_ops: (\d+) \}",
     lambda m, s: MulExtensionGate(int(m[1]), s.ext_degree)),
    (r"ReducingGate \{ num_coeffs: (\d+) \}",
     lambda m, s: ReducingGate(int(m[1]), s.ext_degree)),
    (r"ReducingExtensionGate \{ num_coeffs: (\d+) \}",
     lambda m, s: ReducingExtensionGate(int(m[1]), s.ext_degree)),
    (r"RandomAccessGate \{ bits: (\d+), num_copies: (\d+), "
     r"num_extra_constants: (\d+) \}",
     lambda m, s: RandomAccessGate(int(m[1]), int(m[2]), int(m[3]))),
    (r"ExponentiationGate \{ num_power_bits: (\d+), _phantom: "
     r"PhantomData<[\w:]+> \}<D=\d>",
     lambda m, s: ExponentiationGate(int(m[1]), s)),
    (r"BaseSumGate \{ num_limbs: (\d+) \} \+ Base: (\d+)",
     lambda m, s: BaseSumGate(int(m[1]), int(m[2]))),
    (r"(\d+),(\d+),\[([\d, ]*)\]<D=(\d+)>",
     lambda m, s: CosetInterpolationGate(
         int(m[1]), int(m[2]),
         [int(w) for w in m[3].split(",") if w.strip()], s)),
    (r"PoseidonMdsGate\(PhantomData<plonky2_field::goldilocks_field::"
     r"GoldilocksField>\)<WIDTH=12>",
     lambda m, s: PoseidonMdsGate(s.ext_degree)),
]
_PATTERNS = [(re.compile(p), make) for p, make in _PATTERNS]


_LOOKUP_PATTERNS = [
    (re.compile(r"LookupGate \{num_slots: (\d+), lut_hash: \[[\d, ]*\]\}"),
     lambda m, lut: LookupGate(int(m[1]), lut)),
    (re.compile(r"LookupTableGate \{num_slots: (\d+), lut_hash: "
                r"\[[\d, ]*\], last_lut_row: (\d+)\}"),
     lambda m, lut: LookupTableGate(int(m[1]), lut, int(m[2]))),
]


def gate_from_id(gate_id: str, spec: host.FieldSpec = host.GOLDILOCKS,
                 luts=()) -> Gate:
    """The port's gate for a reference id string over the field of
    ``spec`` (a lookup gate's table among ``luts``, by its hash); raises on
    any other."""
    for pattern, make in _LOOKUP_PATTERNS:
        m = pattern.fullmatch(gate_id)
        if m:
            for lut in luts:
                gate = make(m, tuple(tuple(e) for e in lut))
                if gate.id() == gate_id:
                    return gate
            raise ValueError(f"no table of the circuit has the hash of "
                             f"{gate_id!r}")
    for pattern, make in _PATTERNS:
        m = pattern.fullmatch(gate_id)
        if m:
            gate = make(m, spec)
            if gate.id() != gate_id:
                raise ValueError(f"gate {gate_id!r} reads as {gate.id()!r}")
            return gate
    raise ValueError(f"gate {gate_id!r} is not ported")
