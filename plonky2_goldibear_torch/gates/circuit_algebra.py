"""The circuit algebra: a gate's constraints evaluated into a circuit
(the JAX package's ``gates/circuit_algebra.py``).

A value is an extension target (a tuple of D targets) and every operation
calls a ``CircuitBuilder`` gadget, so running a gate's ``eval_unfiltered``
over this algebra builds its constraint check into the circuit: the
reference's hand-written ``eval_unfiltered_circuit`` (gate.rs:150-161),
here from the one definition that the verifier and the prover run too.
The fused operations call the gadgets the reference's circuit code calls,
in its order, so the circuit's layout (and digest) is the reference's.
"""

from __future__ import annotations

from ..iop import target as tgt
from .base import _FusedOpsMixin
from .poseidon_mds import PoseidonMdsGate


class CircuitExtAlgebra(_FusedOpsMixin):
    """Values are extension targets; base-field scalars (challenges) are
    targets.  The logUp terms' ``product``, ``leave_one_out_sum``,
    ``add_scaled`` and ``horner`` are the mixin's loops over the gadgets
    below, the order of the reference's lookup circuit code."""

    def __init__(self, builder):
        self.b = builder
        self.spec = builder.spec

    def from_int(self, c: int):
        return self.b.constant_extension(c)

    def zero(self):
        return self.b.zero_extension()

    def one(self):
        return self.b.one_extension()

    def add(self, a, b):
        return self.b.add_extension(a, b)

    def sub(self, a, b):
        return self.b.sub_extension(a, b)

    def mul(self, a, b):
        return self.b.mul_extension(a, b)

    def mul_base_const(self, a, c: int):
        return self.b.mul_const_extension(c, a)

    def add_base_const(self, a, c: int):
        return self.b.add_extension(a, self.b.constant_extension(c))

    def mul_add(self, a, b, c):
        return self.b.mul_add_extension(a, b, c)

    def mul_sub(self, a, b, c):
        return self.b.mul_sub_extension(a, b, c)

    def mul_many(self, terms):
        return self.b.mul_many_extension(terms)

    def const_mul_add(self, c: int, x, acc):
        """c * x + acc, the constant routed as a target (the reference's
        Poseidon circuit helpers)."""
        return self.b.mul_add_extension(self.b.constant_extension(c), x, acc)

    def const_mul(self, c: int, x):
        return self.b.mul_const_extension(c, x)

    def k_const_mul(self, k: int, x):
        """constant(k), then scalar_mul_ext (reference
        vanishing_poly.rs:906-910)."""
        return self.b.scalar_mul_ext(self.b.constant(k), x)

    def scalar_mul_add(self, s, b_, c):
        """s * b + c in one op: convert_to_ext(s), then mul_add_extension
        (reference vanishing_poly.rs:943-952)."""
        return self.b.mul_add_extension(self.b.convert_to_ext(s), b_, c)

    def exp7(self, x):
        return self.b.exp_u64_extension(x, 7)

    def reduce_with_powers(self, terms, alpha):
        """convert_to_ext(alpha), then ReducingFactorTarget.reduce
        (reference vanishing_poly.rs:977-984)."""
        from ..plonk.gadgets import ReducingFactorTarget

        red = ReducingFactorTarget(self.b.convert_to_ext(alpha))
        return red.reduce(list(terms), self.b)

    def poseidon_mds_layer(self, state):
        """A full-round Poseidon MDS layer through one PoseidonMdsGate row
        (reference poseidon_goldilocks.rs:597-620 mds_layer_circuit); the
        caller checks that the routed wires hold it
        (``hash/poseidon_gl.py:mds_gate_fits``)."""
        gate = PoseidonMdsGate(self.spec.ext_degree)
        row = self.b.add_gate(gate, [])
        for i, s in enumerate(state):
            self.b.connect_extension(
                s, tuple(tgt.wire(row, w) for w in gate.wires_input(i)))
        return [tuple(tgt.wire(row, w) for w in gate.wires_output(i))
                for i in range(len(state))]

    def mul_scalar(self, a, s):
        return self.b.scalar_mul_ext(s, a)

    def lift_scalar(self, s):
        return self.b.convert_to_ext(s)
