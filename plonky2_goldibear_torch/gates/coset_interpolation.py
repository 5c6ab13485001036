"""CosetInterpolationGate, constraint side: the values on a coset of the
2^bits subgroup, interpolated and evaluated at an extension point, the FRI
fold check of the recursive verifier (reference
plonky2/src/gates/coset_interpolation.rs; the JAX package's
``gates/coset_interpolation.py``).

The interpolation runs over the fixed subgroup, with the barycentric
weights in the gate, and the coset shift goes into the point:
P(X) = P'(X / shift).  Every (degree - 1)-th intermediate of the running
(eval, prod) pair is stored in non-routed wires.  Witness generator and
quotient evaluation: ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

from typing import List, Sequence

from ..field import host
from .base import (Gate, ext_algebra_add, ext_algebra_mul,
                   ext_algebra_scalar_mul, ext_algebra_sub,
                   generators_not_ported)


def barycentric_weights_subgroup(spec: host.FieldSpec,
                                 subgroup_bits: int) -> List[int]:
    """w_i = 1 / prod_{j != i} (x_i - x_j) over the 2^bits subgroup
    (reference field/src/interpolation.rs:13-32)."""
    pts = host.two_adic_subgroup(spec, subgroup_bits)
    p = spec.p
    prods = []
    for i, xi in enumerate(pts):
        acc = 1
        for j, xj in enumerate(pts):
            if j != i:
                acc = acc * (xi - xj) % p
        prods.append(acc)
    return host.batch_inv(prods, p)


def _partial_interpolate_a(A, domain: Sequence[int], values, weights, x,
                           ev, prod):
    """reference coset_interpolation.rs:608-635, over the algebra."""
    for val, w, x_i in zip(values, weights, domain):
        val_w = [A.mul_base_const(c, w) for c in val]
        term = list(x)
        term[0] = A.add_base_const(term[0], (-x_i) % A.spec.p)
        ev = ext_algebra_add(A, ext_algebra_mul(A, A.spec, ev, term),
                             ext_algebra_mul(A, A.spec, val_w, prod))
        prod = ext_algebra_mul(A, A.spec, prod, term)
    return ev, prod


class CosetInterpolationGate(Gate):
    """Wires: the shift, 2^bits values, the evaluation point and value,
    the intermediate evals and prods, the shifted point (D each but the
    shift)."""

    def __init__(self, subgroup_bits: int, degree: int, weights,
                 spec: host.FieldSpec = host.GOLDILOCKS):
        """The gate as serialized (reference coset_interpolation.rs
        deserialize); the weights must be the subgroup's."""
        self.subgroup_bits = subgroup_bits
        self.D = spec.ext_degree
        self.gate_degree = degree
        self.barycentric_weights = list(weights)
        self.domain = host.two_adic_subgroup(spec, subgroup_bits)
        if self.barycentric_weights != barycentric_weights_subgroup(
                spec, subgroup_bits):
            raise ValueError("serialized barycentric weights disagree with "
                             "the subgroup")

    def id(self):
        return (f"{self.subgroup_bits},{self.gate_degree},"
                f"{self.barycentric_weights}<D={self.D}>")

    @property
    def num_points(self):
        return 1 << self.subgroup_bits

    def wire_shift(self):
        return 0

    def wires_value(self, i):
        return range(1 + i * self.D, 1 + (i + 1) * self.D)

    def _ext_at(self, start):
        return range(start, start + self.D)

    def wires_evaluation_point(self):
        return self._ext_at(1 + self.num_points * self.D)

    def wires_evaluation_value(self):
        return self._ext_at(1 + (self.num_points + 1) * self.D)

    def _start_intermediates(self):
        return 1 + (self.num_points + 2) * self.D

    def num_intermediates(self):
        return (self.num_points - 2) // (self.gate_degree - 1)

    def wires_intermediate_eval(self, i):
        return self._ext_at(self._start_intermediates() + self.D * i)

    def wires_intermediate_prod(self, i):
        return self._ext_at(self._start_intermediates()
                            + self.D * (self.num_intermediates() + i))

    def wires_shifted_evaluation_point(self):
        return self._ext_at(self._start_intermediates()
                            + 2 * self.D * self.num_intermediates())

    def num_wires(self):
        return self._start_intermediates() + self.D * (
            2 * self.num_intermediates() + 1)

    def num_constants(self):
        return 0

    def degree(self):
        return self.gate_degree

    def num_constraints(self):
        return 2 * self.D + 2 * self.D * self.num_intermediates()

    generators = generators_not_ported

    def eval_unfiltered(self, A, vars):
        lw = vars.local_wires
        D = self.D

        def ext(wires):
            return [lw[w] for w in wires]

        shifted_point = ext(self.wires_shifted_evaluation_point())
        constraints = ext_algebra_sub(
            A, ext(self.wires_evaluation_point()),
            ext_algebra_scalar_mul(A, shifted_point, lw[self.wire_shift()]))
        values = [ext(self.wires_value(i)) for i in range(self.num_points)]
        d = self.gate_degree
        ev, prod = _partial_interpolate_a(
            A, self.domain[:d], values[:d], self.barycentric_weights[:d],
            shifted_point, [A.zero()] * D, [A.one()] + [A.zero()] * (D - 1))
        for i in range(self.num_intermediates()):
            inter_ev = ext(self.wires_intermediate_eval(i))
            inter_prod = ext(self.wires_intermediate_prod(i))
            constraints += ext_algebra_sub(A, inter_ev, ev)
            constraints += ext_algebra_sub(A, inter_prod, prod)
            start = 1 + (d - 1) * (i + 1)
            end = min(start + d - 1, self.num_points)
            ev, prod = _partial_interpolate_a(
                A, self.domain[start:end], values[start:end],
                self.barycentric_weights[start:end], shifted_point,
                inter_ev, inter_prod)
        constraints += ext_algebra_sub(A, ext(self.wires_evaluation_value()),
                                       ev)
        return constraints
