"""Gates, constraint side, and the id strings the port accepts."""

import re

from .base import Gate
from .basic_gates import ArithmeticGate, ConstantGate, NoopGate, \
    PublicInputGate
from .poseidon import PoseidonGate
from .poseidon2_bb_gate import Poseidon2BabyBearGate

_PATTERNS = [
    (re.compile(r"ArithmeticGate \{ num_ops: (\d+) \}"),
     lambda m: ArithmeticGate(int(m.group(1)))),
    (re.compile(r"ConstantGate \{ num_consts: (\d+) \}"),
     lambda m: ConstantGate(int(m.group(1)))),
    (re.compile(r"PublicInputGate<(\d+)>"),
     lambda m: PublicInputGate(int(m.group(1)))),
    (re.compile(r"NoopGate"), lambda m: NoopGate()),
    (re.compile(r"PoseidonGate<WIDTH=12>"), lambda m: PoseidonGate()),
    (re.compile(r"Poseidon2BabyBearGate \{ num_ops: (\d+), _phantom: "
                r"PhantomData<p3_baby_bear::baby_bear::BabyBear> \}"
                r"<WIDTH=16>"),
     lambda m: Poseidon2BabyBearGate(int(m.group(1)))),
]


def gate_from_id(gate_id: str) -> Gate:
    """The port's gate for a reference id string; raises on any other."""
    for pattern, make in _PATTERNS:
        m = pattern.fullmatch(gate_id)
        if m:
            return make(m)
    raise ValueError(f"gate {gate_id!r} is not ported")
