"""ApplyMat4Gate and Poseidon2InternalPermutationGate (reference
plonky2/src/gates/{apply_mat4.rs, poseidon2_internal_permutation.rs}; the
JAX package's ``gates/misc_gates.py:84-225``): the linear layers of the
width-16 Poseidon2 over extension elements, one gate each.  The reference
serializes them (gate tags 18 and 19); no builder gadget of the reference
or of the JAX package places them.  Each extension element is D wires, and
each of its D components goes through the layer on its own.  AddManyGate,
the third gate of the JAX module (tag 17), waits for ROADMAP Queue 1
item 4b.
"""

from __future__ import annotations

from typing import List

from ..hash import _poseidon2_bb_constants as C
from ..hash import poseidon2_bb as p2
from ..iop import generator as gen
from ..iop import target as tgt
from .base import EvaluationVars, Gate, HostBaseAlgebra

W = C.SPONGE_WIDTH


class ApplyMat4Gate(Gate):
    """The 4x4 M4 block of the external layer (apply_mat4.rs); op ``op``
    takes 4 extension inputs and gives 4 extension outputs."""

    def __init__(self, num_ops: int, D: int):
        self.num_ops = num_ops
        self.D = D

    @classmethod
    def from_config(cls, config, D: int):
        return cls(config.num_routed_wires // (8 * D), D)

    def id(self):
        return (f"ApplyMat4Gate {{ num_ops: {self.num_ops}, _phantom: "
                f"PhantomData<p3_baby_bear::baby_bear::BabyBear> "
                f"}}<D={self.D}>")

    def wires_input(self, op, i):
        base = 8 * self.D * op + i * self.D
        return range(base, base + self.D)

    def wires_output(self, op, i):
        base = 8 * self.D * op + (4 + i) * self.D
        return range(base, base + self.D)

    def num_wires(self):
        return 8 * self.D * self.num_ops

    def num_constants(self):
        return 0

    def degree(self):
        return 1

    def num_constraints(self):
        return 4 * self.D * self.num_ops

    def eval_unfiltered(self, A, vars: EvaluationVars) -> List:
        lw = vars.local_wires
        out = []
        for op in range(self.num_ops):
            for d in range(self.D):
                y = p2.apply_mat4_a(
                    A, [lw[self.wires_input(op, i)[d]] for i in range(4)])
                out += [A.sub(y[i], lw[self.wires_output(op, i)[d]])
                        for i in range(4)]
        return out

    def generators(self, row, local_constants, spec):
        return [_ApplyMat4Generator(self, row, op, spec)
                for op in range(self.num_ops)]


class _ApplyMat4Generator(gen.SimpleGenerator):
    def __init__(self, gate, row, op, spec):
        self.gate, self.row, self.op, self.spec = gate, row, op, spec

    def dependencies(self):
        return [tgt.wire(self.row, w) for i in range(4)
                for w in self.gate.wires_input(self.op, i)]

    def run_once(self, witness, out):
        A = HostBaseAlgebra(self.spec)
        g, row, op = self.gate, self.row, self.op
        for d in range(g.D):
            y = p2.apply_mat4_a(A, [
                witness.get_target(tgt.wire(row, g.wires_input(op, i)[d]))
                for i in range(4)])
            out.extend((tgt.wire(row, g.wires_output(op, i)[d]), y[i])
                       for i in range(4))


class Poseidon2InternalPermutationGate(Gate):
    """One width-16 Poseidon2 internal (diffusion) layer
    (poseidon2_internal_permutation.rs): 16 extension inputs, 16
    extension outputs."""

    def __init__(self, D: int):
        self.D = D

    def id(self):
        return ("Poseidon2InternalPermutationGate { _phantom: PhantomData"
                f"<p3_baby_bear::baby_bear::BabyBear> }}<D={self.D}>")

    def wires_input(self, i):
        return range(i * self.D, (i + 1) * self.D)

    def wires_output(self, i):
        return range((W + i) * self.D, (W + i + 1) * self.D)

    def num_wires(self):
        return 2 * W * self.D

    def num_constants(self):
        return 0

    def degree(self):
        return 1

    def num_constraints(self):
        return W * self.D

    def eval_unfiltered(self, A, vars: EvaluationVars) -> List:
        lw = vars.local_wires
        out = []
        for d in range(self.D):
            y = p2.internal_layer_a(A, [lw[self.wires_input(i)[d]]
                                        for i in range(W)])
            out += [A.sub(y[i], lw[self.wires_output(i)[d]])
                    for i in range(W)]
        return out

    def generators(self, row, local_constants, spec):
        return [_InternalPermGenerator(self, row, spec)]


class _InternalPermGenerator(gen.SimpleGenerator):
    def __init__(self, gate, row, spec):
        self.gate, self.row, self.spec = gate, row, spec

    def dependencies(self):
        return [tgt.wire(self.row, w) for i in range(W)
                for w in self.gate.wires_input(i)]

    def run_once(self, witness, out):
        A = HostBaseAlgebra(self.spec)
        g, row = self.gate, self.row
        for d in range(g.D):
            y = p2.internal_layer_a(A, [
                witness.get_target(tgt.wire(row, g.wires_input(i)[d]))
                for i in range(W)])
            out.extend((tgt.wire(row, g.wires_output(i)[d]), y[i])
                       for i in range(W))
