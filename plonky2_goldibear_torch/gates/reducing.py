"""Reducing gates, constraint side: Horner folds acc' = acc * alpha + c_i
over base or extension coefficients (reference plonky2/src/gates/
{reducing.rs, reducing_extension.rs}; the JAX package's
``gates/reducing.py``).  The recursive verifier's Horner reductions
(``plonk/gadgets.py:ReducingFactorTarget``) place them; one generator a
row fills the accumulators.
"""

from __future__ import annotations

from ..field import host
from ..iop import generator as gen
from ..iop import target as tgt
from .base import Gate, ext_algebra_add, ext_algebra_mul, ext_algebra_sub


class _Reducing(Gate):
    """Wires: output (D), alpha (D), old accumulator (D), the
    coefficients, then the intermediate accumulators (D each); the last
    accumulator is the output."""

    coeff_width = 1          # wires per coefficient
    name = ""

    def __init__(self, num_coeffs: int, D: int):
        self.num_coeffs = num_coeffs
        self.D = D

    def id(self):
        return f"{self.name} {{ num_coeffs: {self.num_coeffs} }}"

    def wires_output(self):
        return range(0, self.D)

    def wires_alpha(self):
        return range(self.D, 2 * self.D)

    def wires_old_acc(self):
        return range(2 * self.D, 3 * self.D)

    def wires_coeff(self, i):
        start = 3 * self.D + i * self.coeff_width
        return range(start, start + self.coeff_width)

    def _start_accs(self):
        return 3 * self.D + self.num_coeffs * self.coeff_width

    def wires_accs(self, i):
        if i == self.num_coeffs - 1:
            return self.wires_output()
        start = self._start_accs() + self.D * i
        return range(start, start + self.D)

    def num_wires(self):
        return self._start_accs() + self.D * (self.num_coeffs - 1)

    def num_constants(self):
        return 0

    def degree(self):
        return 2

    def num_constraints(self):
        return self.D * self.num_coeffs

    def generators(self, row, local_constants, spec):
        return [_ReducingGenerator(self, row, spec)]

    def _add_coeff(self, A, term, coeff):
        raise NotImplementedError

    def eval_unfiltered(self, A, vars):
        lw = vars.local_wires
        alpha = [lw[w] for w in self.wires_alpha()]
        acc = [lw[w] for w in self.wires_old_acc()]
        out = []
        for i in range(self.num_coeffs):
            acc_i = [lw[w] for w in self.wires_accs(i)]
            term = self._add_coeff(A, ext_algebra_mul(A, A.spec, acc, alpha),
                                   [lw[w] for w in self.wires_coeff(i)])
            out.extend(ext_algebra_sub(A, term, acc_i))
            acc = acc_i
        return out


class ReducingGate(_Reducing):
    """sum alpha^i c_i for base-field coefficients (reference
    reducing.rs)."""

    name = "ReducingGate"

    @staticmethod
    def max_coeffs_len(num_wires, num_routed_wires, D):
        return min(num_routed_wires - 3 * D, (num_wires - 2 * D) // (D + 1))

    def _add_coeff(self, A, term, coeff):
        term[0] = A.add(term[0], coeff[0])
        return term


class ReducingExtensionGate(_Reducing):
    """sum alpha^i c_i for extension coefficients (reference
    reducing_extension.rs)."""

    name = "ReducingExtensionGate"

    @staticmethod
    def max_coeffs_len(num_wires, num_routed_wires, D):
        return min((num_routed_wires - 3 * D) // D,
                   (num_wires - 2 * D) // (2 * D))

    def __init__(self, num_coeffs: int, D: int):
        super().__init__(num_coeffs, D)
        self.coeff_width = D

    def _add_coeff(self, A, term, coeff):
        return ext_algebra_add(A, term, coeff)


class _ReducingGenerator(gen.SimpleGenerator):
    """acc_i = acc_(i-1) * alpha + c_i on the host, every accumulator."""

    def __init__(self, gate, row, spec):
        self.gate, self.row, self.spec = gate, row, spec

    def dependencies(self):
        g = self.gate
        wires = list(g.wires_alpha()) + list(g.wires_old_acc())
        for i in range(g.num_coeffs):
            wires += list(g.wires_coeff(i))
        return [tgt.wire(self.row, w) for w in wires]

    def run_once(self, witness, out):
        g, spec = self.gate, self.spec

        def get(wires):
            return tuple(witness.get_target(tgt.wire(self.row, w))
                         for w in wires)

        alpha, acc = get(g.wires_alpha()), get(g.wires_old_acc())
        for i in range(g.num_coeffs):
            c = get(g.wires_coeff(i))
            if len(c) == 1:
                c = host.ext_from_base(spec, c[0])
            acc = host.ext_add(spec, host.ext_mul(spec, acc, alpha), c)
            for w, v in zip(g.wires_accs(i), acc):
                out.append((tgt.wire(self.row, w), v))
