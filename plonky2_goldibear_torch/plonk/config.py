"""Circuit / FRI configuration (reference plonky2/src/plonk/circuit_data.rs:
55-190, fri/mod.rs:26-115).

The port receives a circuit's configuration with the circuit itself
(``circuit_data.load_circuit``), FRI reduction arities included, so it
keeps no arity strategy.  The presets of the two fields' recursion configs
(reference circuit_data.rs:102-187) name what a loaded circuit is held to.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
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

    # -- presets (reference circuit_data.rs:102-187) ------------------------

    @staticmethod
    def _standard_base() -> "CircuitConfig":
        return CircuitConfig(
            num_wires=0, num_routed_wires=80, num_constants=2,
            use_base_arithmetic_gate=True, security_bits=100,
            num_challenges=0, zero_knowledge=False,
            max_quotient_degree_factor=8,
            fri_config=FriConfig(rate_bits=3, cap_height=4,
                                 proof_of_work_bits=16,
                                 num_query_rounds=28))

    @staticmethod
    def standard_recursion_config_gl() -> "CircuitConfig":
        """135 wires, 80 routed, 2 challenges (FRI arity 2^4)."""
        return replace(CircuitConfig._standard_base(), num_wires=135,
                       num_challenges=2)

    @staticmethod
    def recursion_config_bb_narrow() -> "CircuitConfig":
        """167 wires, 41 routed, 6 challenges (FRI arity 2^3)."""
        return replace(CircuitConfig._standard_base(), num_wires=167,
                       num_routed_wires=41, num_challenges=6)

    @staticmethod
    def standard_recursion_config_bb() -> "CircuitConfig":
        return CircuitConfig.recursion_config_bb_narrow()
