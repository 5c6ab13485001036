"""Extension-field arithmetic gates, constraint side (reference
plonky2/src/gates/{arithmetic_extension.rs, multiplication_extension.rs};
the JAX package's ``gates/extension_gates.py``).

Each op's operands are D wires, the coefficients of one extension
element; an op's constraints are the D coefficients of its residual in
F_D[X]/(X^D - W).  Their witness generators and quotient evaluation come
with the builder's use of them (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from .base import (Gate, ext_algebra_add, ext_algebra_mul,
                   ext_algebra_scalar_mul, ext_algebra_sub,
                   generators_not_ported)


class ArithmeticExtensionGate(Gate):
    """output = const_0 * m0 * m1 + const_1 * addend over the extension;
    op i uses wires [4D i, 4D (i + 1)) (reference
    arithmetic_extension.rs:27-110)."""

    def __init__(self, num_ops: int, D: int):
        self.num_ops = num_ops
        self.D = D

    def id(self):
        return f"ArithmeticExtensionGate {{ num_ops: {self.num_ops} }}"

    def wires_op(self, i: int):
        D = self.D
        base = 4 * D * i
        return tuple(range(base + k * D, base + (k + 1) * D)
                     for k in range(4))

    def num_wires(self):
        return 4 * self.D * self.num_ops

    def num_constants(self):
        return 2

    def degree(self):
        return 3

    def num_constraints(self):
        return self.num_ops * self.D

    generators = generators_not_ported

    def eval_unfiltered(self, A, vars):
        c0, c1 = vars.local_constants[0], vars.local_constants[1]
        lw = vars.local_wires
        out = []
        for i in range(self.num_ops):
            m0, m1, ad, o = ([lw[w] for w in r] for r in self.wires_op(i))
            computed = ext_algebra_add(
                A, ext_algebra_scalar_mul(
                    A, ext_algebra_mul(A, A.spec, m0, m1), c0),
                ext_algebra_scalar_mul(A, ad, c1))
            out.extend(ext_algebra_sub(A, o, computed))
        return out


class MulExtensionGate(Gate):
    """output = const_0 * m0 * m1 over the extension; op i uses wires
    [3D i, 3D (i + 1)) (reference multiplication_extension.rs:27-95)."""

    def __init__(self, num_ops: int, D: int):
        self.num_ops = num_ops
        self.D = D

    def id(self):
        return f"MulExtensionGate {{ num_ops: {self.num_ops} }}"

    def wires_op(self, i: int):
        D = self.D
        base = 3 * D * i
        return tuple(range(base + k * D, base + (k + 1) * D)
                     for k in range(3))

    def num_wires(self):
        return 3 * self.D * self.num_ops

    def num_constants(self):
        return 1

    def degree(self):
        return 3

    def num_constraints(self):
        return self.num_ops * self.D

    generators = generators_not_ported

    def eval_unfiltered(self, A, vars):
        c0 = vars.local_constants[0]
        lw = vars.local_wires
        out = []
        for i in range(self.num_ops):
            m0, m1, o = ([lw[w] for w in r] for r in self.wires_op(i))
            computed = ext_algebra_scalar_mul(
                A, ext_algebra_mul(A, A.spec, m0, m1), c0)
            out.extend(ext_algebra_sub(A, o, computed))
        return out
