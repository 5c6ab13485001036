"""Circuit / FRI configuration (reference plonky2/src/plonk/circuit_data.rs:
55-190, fri/mod.rs:26-115).

The port receives a circuit's configuration with the circuit itself
(``circuit_data.load_circuit``), FRI reduction arities included, so it
keeps no presets and no arity strategy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int
    cap_height: int
    proof_of_work_bits: int
    num_query_rounds: int


@dataclass(frozen=True)
class FriParams:
    config: FriConfig
    hiding: bool
    degree_bits: int
    reduction_arity_bits: Tuple[int, ...]

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.config.rate_bits

    @property
    def lde_size(self) -> int:
        return 1 << self.lde_bits

    @property
    def final_poly_len(self) -> int:
        return 1 << (self.degree_bits - sum(self.reduction_arity_bits))


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int
    num_routed_wires: int
    num_constants: int
    use_base_arithmetic_gate: bool
    security_bits: int
    num_challenges: int
    zero_knowledge: bool
    max_quotient_degree_factor: int
    fri_config: FriConfig
