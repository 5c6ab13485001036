"""Binomial extensions F_p[X]/(X^D - W) over the torch base fields: gl2
(Goldilocks, X^2 - 7) and bb4 (BabyBear, X^4 - 11).

An extension array is a tuple of D base-field tensors (struct of arrays),
as in the JAX package's ``field/ext.py``; the host semantic reference is
``host.ext_*``.
"""

from __future__ import annotations

import torch

from . import bb as bb_mod
from . import gl as gl_mod
from . import host


class ExtOps:
    """Extension-field operations over a torch base-field module (``gl`` or
    ``bb``)."""

    def __init__(self, base, spec: host.FieldSpec):
        self.base = base
        self.spec = spec
        self.D = spec.ext_degree
        self.W = spec.ext_w
        p, d, w = spec.p, spec.ext_degree, spec.ext_w
        z = pow(w, (p - 1) // d, p)
        # frobenius coefficient scalings: _frob_scale[c][i] = z^(c*i)
        self._frob_scale = [[pow(z, (c * i) % d, p) for i in range(d)]
                            for c in range(d)]

    def ones(self, shape, device="cpu"):
        return (self.base.ones(shape, device),) + tuple(
            self.base.zeros(shape, device) for _ in range(self.D - 1))

    def from_base(self, x):
        return (x,) + tuple(torch.zeros_like(x) for _ in range(self.D - 1))

    def to_ints(self, x):
        return tuple(self.base.to_ints(c) for c in x)

    def add(self, a, b):
        return tuple(self.base.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.base.sub(x, y) for x, y in zip(a, b))

    def mul(self, a, b):
        d, w = self.D, self.W
        acc = [None] * (2 * d - 1)
        for i in range(d):
            for j in range(d):
                t = self.base.mul(a[i], b[j])
                k = i + j
                acc[k] = t if acc[k] is None else self.base.add(acc[k], t)
        out = list(acc[:d])
        for k in range(d, 2 * d - 1):
            out[k - d] = self.base.add(out[k - d],
                                       self.base.mul_const(acc[k], w))
        return tuple(out)

    def scalar_mul(self, a, s):
        """ext * base-field array."""
        return tuple(self.base.mul(x, s) for x in a)

    def frobenius(self, a, count: int = 1):
        scales = self._frob_scale[count % self.D]
        return tuple(x if s == 1 else self.base.mul_const(x, s)
                     for x, s in zip(a, scales))

    def inv(self, a):
        """Inverse via the norm map: conj(a) * N(a)^-1, N(a) in the base
        field (one base-field inversion for the whole batch)."""
        conj = None
        for i in range(1, self.D):
            f = self.frobenius(a, i)
            conj = f if conj is None else self.mul(conj, f)
        norm = self.mul(a, conj)[0]  # remaining coeffs are zero by theory
        return self.scalar_mul(conj, self.base.inv(norm))


gl2 = ExtOps(gl_mod, host.GOLDILOCKS)
bb4 = ExtOps(bb_mod, host.BABYBEAR)


def ext_ops(F) -> ExtOps:
    """The extension over base-field module ``F``."""
    return gl2 if F is gl_mod else bb4
