"""PoseidonMdsGate, constraint side: one width-12 Poseidon MDS layer over
extension elements, coefficient by coefficient (reference
plonky2/src/gates/poseidon_goldilocks_mds.rs; the JAX package's
``gates/poseidon_mds.py``).  The recursive verifier's in-circuit Poseidon
rounds place it (``gates/circuit_algebra.py:poseidon_mds_layer``).
"""

from __future__ import annotations

from ..hash import _poseidon_gl_constants as C
from ..iop import generator as gen
from ..iop import target as tgt
from .base import Gate

W = C.SPONGE_WIDTH


class PoseidonMdsGate(Gate):
    """Wires: 12 inputs then 12 outputs, D coefficients each."""

    def __init__(self, D: int = 2):
        self.D = D

    def id(self):
        return ("PoseidonMdsGate(PhantomData<plonky2_field::goldilocks_"
                f"field::GoldilocksField>)<WIDTH={W}>")

    def wires_input(self, i):
        return range(i * self.D, (i + 1) * self.D)

    def wires_output(self, i):
        return range((W + i) * self.D, (W + i + 1) * self.D)

    def num_wires(self):
        return 2 * self.D * W

    def num_constants(self):
        return 0

    def degree(self):
        return 1

    def num_constraints(self):
        return W * self.D

    def generators(self, row, local_constants, spec):
        return [_MdsGenerator(self, row, spec)]

    def eval_unfiltered(self, A, vars):
        """Each output lane's D coefficients computed before their D
        constraints, in the JAX gate's order: over ``CircuitExtAlgebra``
        the order of the ops is the recursive verifier's layout."""
        lw = vars.local_wires
        inputs = [[lw[w] for w in self.wires_input(i)] for i in range(W)]
        out = []
        for r in range(W):
            computed = []
            for d in range(self.D):
                acc = None
                for i in range(W):
                    t = A.mul_base_const(inputs[(i + r) % W][d],
                                         C.MDS_MATRIX_CIRC[i])
                    acc = t if acc is None else A.add(acc, t)
                computed.append(A.add(acc, A.mul_base_const(
                    inputs[r][d], C.MDS_MATRIX_DIAG[r])))
            out += [A.sub(lw[w], c)
                    for w, c in zip(self.wires_output(r), computed)]
        return out


class _MdsGenerator(gen.SimpleGenerator):
    """The 12 outputs of the MDS layer, coefficient by coefficient."""

    def __init__(self, gate, row, spec):
        self.gate, self.row, self.spec = gate, row, spec

    def dependencies(self):
        return [tgt.wire(self.row, w) for i in range(W)
                for w in self.gate.wires_input(i)]

    def run_once(self, witness, out):
        g, p = self.gate, self.spec.p
        inputs = [[witness.get_target(tgt.wire(self.row, w))
                   for w in g.wires_input(i)] for i in range(W)]
        for r in range(W):
            for d, w in enumerate(g.wires_output(r)):
                acc = sum(C.MDS_MATRIX_CIRC[i] * inputs[(i + r) % W][d]
                          for i in range(W))
                acc += C.MDS_MATRIX_DIAG[r] * inputs[r][d]
                out.append((tgt.wire(self.row, w), acc % p))
