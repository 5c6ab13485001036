"""Extension-field arithmetic gates, constraint side (reference
plonky2/src/gates/{arithmetic_extension.rs, multiplication_extension.rs};
the JAX package's ``gates/extension_gates.py``).

Each op's operands are D wires, the coefficients of one extension
element; an op's constraints are the D coefficients of its residual in
F_D[X]/(X^D - W).  The builder packs ops with equal constants into one
row (``plonk/builder.py:arithmetic_extension``); each op has its own
generator.
"""

from __future__ import annotations

from ..field import host
from ..iop import generator as gen
from ..iop import target as tgt
from .base import (Gate, ext_algebra_add, ext_algebra_mul,
                   ext_algebra_scalar_mul, ext_algebra_sub)


class ArithmeticExtensionGate(Gate):
    """output = const_0 * m0 * m1 + const_1 * addend over the extension;
    op i uses wires [4D i, 4D (i + 1)) (reference
    arithmetic_extension.rs:27-110)."""

    def __init__(self, num_ops: int, D: int):
        self.num_ops = num_ops
        self.D = D

    @classmethod
    def from_config(cls, config, D: int):
        return cls(config.num_routed_wires // (4 * D), D)

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

    def generators(self, row, local_constants, spec):
        c0, c1 = int(local_constants[0]), int(local_constants[1])
        return [_ExtensionOpGenerator(self, row, c0, c1, i, spec)
                for i in range(self.num_ops)]

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

    @classmethod
    def from_config(cls, config, D: int):
        return cls(config.num_routed_wires // (3 * D), D)

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

    def generators(self, row, local_constants, spec):
        c0 = int(local_constants[0])
        return [_ExtensionOpGenerator(self, row, c0, None, i, spec)
                for i in range(self.num_ops)]

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


class _ExtensionOpGenerator(gen.SimpleGenerator):
    """The output of one op, c0 * m0 * m1 (+ c1 * addend when the gate has
    an addend, ``c1`` not None), on the host."""

    def __init__(self, gate, row, c0, c1, i, spec):
        self.gate, self.row, self.c0, self.c1, self.i, self.spec = \
            gate, row, c0, c1, i, spec

    def _inputs(self):
        return self.gate.wires_op(self.i)[:-1]

    def dependencies(self):
        return [tgt.wire(self.row, w) for r in self._inputs() for w in r]

    def run_once(self, witness, out):
        spec = self.spec
        vals = [tuple(witness.get_target(tgt.wire(self.row, w)) for w in r)
                for r in self._inputs()]
        res = host.ext_scalar_mul(spec, host.ext_mul(spec, vals[0], vals[1]),
                                  self.c0)
        if self.c1 is not None:
            res = host.ext_add(spec, res,
                               host.ext_scalar_mul(spec, vals[2], self.c1))
        for w, v in zip(self.gate.wires_op(self.i)[-1], res):
            out.append((tgt.wire(self.row, w), v))
