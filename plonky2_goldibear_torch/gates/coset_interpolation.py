"""CosetInterpolationGate, constraint side: the values on a coset of the
2^bits subgroup, interpolated and evaluated at an extension point, the FRI
fold check of the recursive verifier (reference
plonky2/src/gates/coset_interpolation.rs; the JAX package's
``gates/coset_interpolation.py``).

The interpolation runs over the fixed subgroup, with the barycentric
weights in the gate, and the coset shift goes into the point:
P(X) = P'(X / shift).  Every (degree - 1)-th intermediate of the running
(eval, prod) pair is stored in non-routed wires.  The recursive
verifier's FRI folds (``fri/recursive_verifier.py``) place it; its
generator fills the shifted point, the intermediates and the value on the
host.
"""

from __future__ import annotations

from typing import List, Sequence

from ..field import host
from ..iop import generator as gen
from ..iop import target as tgt
from .base import (Gate, ext_algebra_add, ext_algebra_mul,
                   ext_algebra_scalar_mul, ext_algebra_sub)


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

    @classmethod
    def with_max_degree(cls, subgroup_bits: int, max_degree: int,
                        spec: host.FieldSpec = host.GOLDILOCKS):
        """The gate of a circuit whose constraints may have degree
        ``max_degree``: the fewest intermediates, then the least degree
        for them (reference coset_interpolation.rs:72-90)."""
        assert max_degree > 1
        n_points = 1 << subgroup_bits
        n_intermediates = (n_points - 2) // (max_degree - 1)
        degree = (n_points - 2) // (n_intermediates + 1) + 2
        return cls(subgroup_bits, degree,
                   barycentric_weights_subgroup(spec, subgroup_bits), spec)

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

    def generators(self, row, local_constants, spec):
        return [_InterpolationGenerator(self, row, spec)]

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


class _InterpolationGenerator(gen.SimpleGenerator):
    """The shifted point, the intermediates and the value of the
    interpolant, on the host (the constraints' own recurrence)."""

    def __init__(self, gate, row, spec):
        self.gate, self.row, self.spec = gate, row, spec

    def dependencies(self):
        g = self.gate
        wires = [g.wire_shift()]
        for i in range(g.num_points):
            wires += list(g.wires_value(i))
        wires += list(g.wires_evaluation_point())
        return [tgt.wire(self.row, w) for w in wires]

    def run_once(self, witness, out):
        g, spec = self.gate, self.spec

        def get(w):
            return witness.get_target(tgt.wire(self.row, w))

        def put(wires, vals):
            out.extend((tgt.wire(self.row, w), v)
                       for w, v in zip(wires, vals))

        point = tuple(get(w) for w in g.wires_evaluation_point())
        shifted = host.ext_scalar_mul(spec, point,
                                      host.finv(get(g.wire_shift()), spec.p))
        put(g.wires_shifted_evaluation_point(), shifted)
        values = [tuple(get(w) for w in g.wires_value(i))
                  for i in range(g.num_points)]

        def interpolate(lo, hi, ev, prod):
            for val, w, x_i in zip(values[lo:hi],
                                   g.barycentric_weights[lo:hi],
                                   g.domain[lo:hi]):
                term = host.ext_sub(spec, shifted,
                                    host.ext_from_base(spec, x_i))
                ev = host.ext_add(
                    spec, host.ext_mul(spec, ev, term),
                    host.ext_mul(spec, host.ext_scalar_mul(spec, val, w),
                                 prod))
                prod = host.ext_mul(spec, prod, term)
            return ev, prod

        d = g.gate_degree
        ev, prod = interpolate(0, d, host.ext_zero(spec), host.ext_one(spec))
        for i in range(g.num_intermediates()):
            put(g.wires_intermediate_eval(i), ev)
            put(g.wires_intermediate_prod(i), prod)
            start = 1 + (d - 1) * (i + 1)
            ev, prod = interpolate(start, min(start + d - 1, g.num_points),
                                   ev, prod)
        put(g.wires_evaluation_value(), ev)
