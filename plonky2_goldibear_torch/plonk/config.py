"""Circuit / FRI configuration (reference plonky2/src/plonk/circuit_data.rs:
55-190, fri/mod.rs:26-115, fri/reduction_strategies.rs:11-56).

The builder takes the FRI reduction arities from the config's strategy
(``FriConfig.fri_params``); a loaded circuit brings them in its metadata.
The presets are the two fields' recursion configs (reference
circuit_data.rs:102-187): FRI arity 2^4 for Goldilocks, 2^3 for BabyBear;
and the Goldilocks one with zero knowledge.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class FriReductionStrategy:
    """The reference's reduction strategies (fri/reduction_strategies.rs:
    11-130): ``kind`` "constant_arity" (``ConstantArityBits(arity_bits,
    final_poly_bits)``, the presets'), "fixed" (the arities ``fixed``) or
    "min_size" (``MinSize(max_arity_bits)``), which a read circuit may
    carry: its FRI parameters hold the arities, so the port does not
    search them."""

    arity_bits: int = 4
    final_poly_bits: int = 5
    kind: str = "constant_arity"
    fixed: Tuple[int, ...] = ()
    max_arity_bits: Optional[int] = None

    def reduction_arity_bits(self, degree_bits: int, rate_bits: int,
                             cap_height: int) -> List[int]:
        if self.kind == "fixed":
            return list(self.fixed)
        if self.kind != "constant_arity":
            raise NotImplementedError(
                f"the {self.kind} reduction strategy's arity search")
        out = []
        db = degree_bits
        while (db > self.final_poly_bits
               and db + rate_bits - self.arity_bits >= cap_height):
            assert db >= self.arity_bits
            out.append(self.arity_bits)
            db -= self.arity_bits
        return out


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int
    cap_height: int
    proof_of_work_bits: int
    num_query_rounds: int
    reduction_strategy: FriReductionStrategy = FriReductionStrategy()

    def fri_params(self, degree_bits: int, hiding: bool) -> "FriParams":
        return FriParams(
            config=self, hiding=hiding, degree_bits=degree_bits,
            reduction_arity_bits=tuple(
                self.reduction_strategy.reduction_arity_bits(
                    degree_bits, self.rate_bits, self.cap_height)))


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

    def total_arities(self) -> int:
        return sum(self.reduction_arity_bits)

    @property
    def final_poly_len(self) -> int:
        return 1 << (self.degree_bits - self.total_arities())


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
    def _standard_base(arity_bits: int = 3) -> "CircuitConfig":
        return CircuitConfig(
            num_wires=0, num_routed_wires=80, num_constants=2,
            use_base_arithmetic_gate=True, security_bits=100,
            num_challenges=0, zero_knowledge=False,
            max_quotient_degree_factor=8,
            fri_config=FriConfig(
                rate_bits=3, cap_height=4, proof_of_work_bits=16,
                num_query_rounds=28,
                reduction_strategy=FriReductionStrategy(
                    arity_bits=arity_bits, final_poly_bits=5)))

    @staticmethod
    def standard_recursion_config_gl() -> "CircuitConfig":
        """135 wires, 80 routed, 2 challenges (FRI arity 2^4)."""
        return replace(CircuitConfig._standard_base(arity_bits=4),
                       num_wires=135, num_challenges=2)

    @staticmethod
    def standard_recursion_zk_config_gl() -> "CircuitConfig":
        """``standard_recursion_config_gl()`` with zero knowledge: blinding
        rows and salted commitments (reference circuit_data.rs:172-177)."""
        return replace(CircuitConfig.standard_recursion_config_gl(),
                       zero_knowledge=True)

    @staticmethod
    def recursion_config_bb_narrow() -> "CircuitConfig":
        """167 wires, 41 routed, 6 challenges (FRI arity 2^3)."""
        return replace(CircuitConfig._standard_base(), num_wires=167,
                       num_routed_wires=41, num_challenges=6)

    @staticmethod
    def recursion_config_bb_wide() -> "CircuitConfig":
        """334 wires, 160 routed, 6 challenges (FRI arity 2^3): room for a
        width-24 Poseidon2 op in a row."""
        return replace(CircuitConfig._standard_base(), num_wires=334,
                       num_routed_wires=160, num_challenges=6)

    @staticmethod
    def standard_recursion_config_bb() -> "CircuitConfig":
        return CircuitConfig.recursion_config_bb_narrow()
