"""AddManyGate, ApplyMat4Gate and Poseidon2InternalPermutationGate
(reference plonky2/src/gates/{add_many.rs, apply_mat4.rs,
poseidon2_internal_permutation.rs}; the JAX package's
``gates/misc_gates.py``).  AddManyGate (gate tag 17) packs sums of many
addends, one op a sum; the builder's ``add_many`` places it for 23 addends
and more.  The other two are the linear layers of the width-16 Poseidon2
over extension elements, one gate each: the reference serializes them
(gate tags 18 and 19), and no builder gadget of the reference or of the
JAX package places them.  Each extension element is D wires, and each of
its D components goes through the layer on its own.
"""

from __future__ import annotations

from typing import List

from ..hash import _poseidon2_bb_constants as C
from ..hash import poseidon2_bb as p2
from ..iop import generator as gen
from ..iop import target as tgt
from .base import EvaluationVars, Gate, HostBaseAlgebra

W = C.SPONGE_WIDTH


class AddManyGate(Gate):
    """Sums of ``num_addends`` addends (add_many.rs:24-105): op i takes
    the addends on wires [(n+1)i, (n+1)i + n) and the sum on wire
    (n+1)i + n, with one degree-1 constraint."""

    def __init__(self, num_addends: int, num_ops: int):
        self.num_addends = num_addends
        self.num_ops = num_ops

    @classmethod
    def from_config(cls, config, num_addends: int):
        return cls(num_addends, config.num_routed_wires // (num_addends + 1))

    def id(self):
        return (f"AddManyGate {{ num_addends: {self.num_addends}, "
                f"num_ops: {self.num_ops} }}")

    def wires_addends(self, op):
        base = (self.num_addends + 1) * op
        return range(base, base + self.num_addends)

    def wire_sum(self, op):
        return (self.num_addends + 1) * op + self.num_addends

    def num_wires(self):
        return (self.num_addends + 1) * self.num_ops

    def num_constants(self):
        return 0

    def degree(self):
        return 1

    def num_constraints(self):
        return self.num_ops

    def eval_unfiltered(self, A, vars: EvaluationVars) -> List:
        lw = vars.local_wires
        out = []
        for op in range(self.num_ops):
            acc = A.zero()
            for w in self.wires_addends(op):
                acc = A.add(acc, lw[w])
            out.append(A.sub(acc, lw[self.wire_sum(op)]))
        return out

    def generators(self, row, local_constants, spec):
        return [_AddManyGenerator(self, row, op, spec.p)
                for op in range(self.num_ops)]


class _AddManyGenerator(gen.SimpleGenerator):
    def __init__(self, gate, row, op, p):
        self.gate, self.row, self.op, self.p = gate, row, op, p

    def dependencies(self):
        return [tgt.wire(self.row, w)
                for w in self.gate.wires_addends(self.op)]

    def run_once(self, witness, out):
        s = sum(witness.get_targets(self.dependencies())) % self.p
        out.append((tgt.wire(self.row, self.gate.wire_sum(self.op)), s))

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
