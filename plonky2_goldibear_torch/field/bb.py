"""BabyBear arithmetic on torch tensors: p = 2^31 - 2^27 + 1 = 15 * 2^27 + 1.

A field array is an ``int32`` tensor holding the **Montgomery form**
a * R mod p (R = 2^32) of a canonical value, exactly as the JAX package's
``field/bb.py`` stores it, so every intermediate tensor compares bit for
bit with the JAX arrays.  Canonical integers appear only at ``from_ints``
/ ``to_ints``.  Stored residues are canonical (< p < 2^31), so an int32
never goes negative.

The Montgomery product of a and b is a b R^-1 mod p.  It is taken in int64
as ``((a b mod p) R^-1) mod p``: a b < 2^62 and (a b mod p) R^-1 < 2^62, so
nothing overflows a signed int64 (the JAX package's REDC sum ``t + m p``
would), and the result is the canonical residue the JAX REDC gives.  On
the card the plain-torch arithmetic is bound by launches, and this form
takes 7 elementwise launches where a REDC takes 16.  A product by a host
integer c needs no R^-1 at all: the Montgomery map is linear, so
``mont(x) c mod p`` is ``mont(x c)``.  Adds and subtracts stay in int32:
both operands are below p, so ``a - (p - b)`` and ``a - b`` lie in (-p, p).

The same code runs on CPU and CUDA tensors (plain elementwise torch).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..device import upload
from . import host

SPEC = host.BABYBEAR
P = SPEC.p                          # 0x78000001
R = (1 << 32) % P                   # Montgomery R mod p
RINV = pow(R, -1, P)
DTYPE = torch.int32


def _mont(v: int) -> int:
    return (int(v) % P) * R % P


# --------------------------------------------------------------------------
# construction / conversion
# --------------------------------------------------------------------------


def from_ints(vals: Union[Sequence[int], np.ndarray], device="cpu"
              ) -> torch.Tensor:
    """Host ints (canonical or not) -> Montgomery-form tensor on ``device``
    (to the card without blocking the host, ``device.upload``)."""
    a = np.asarray(vals, dtype=np.uint64) % np.uint64(P)
    mont = (a * np.uint64(R)) % np.uint64(P)
    return upload(mont.astype(np.int32), device)


def to_ints(x: torch.Tensor) -> np.ndarray:
    """Montgomery-form tensor -> numpy uint64 canonical values (host sync)."""
    m = x.detach().cpu().numpy().astype(np.uint64)
    return (m * np.uint64(RINV)) % np.uint64(P)


def zeros(shape, device="cpu") -> torch.Tensor:
    return torch.zeros(shape, dtype=DTYPE, device=device)


def ones(shape, device="cpu") -> torch.Tensor:
    return torch.full(shape, R, dtype=DTYPE, device=device)


def full(shape, value: int, device="cpu") -> torch.Tensor:
    return torch.full(shape, _mont(value), dtype=DTYPE, device=device)


def from_canonical(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor of values in [0, 2^32) -> Montgomery form."""
    return (x.to(torch.int64) * R % P).to(DTYPE)


def to_canonical(x: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical values as an int64 tensor."""
    return x.to(torch.int64) * RINV % P


def from_u32(w: torch.Tensor) -> torch.Tensor:
    """Integer tensor of values in [0, 2^32) -> Montgomery forms (the JAX
    package's ``field/bb.py:from_u32``)."""
    return from_canonical(w)


def flag(b: torch.Tensor) -> torch.Tensor:
    """A bool tensor as the field elements 1 and 0."""
    return from_u32(b.to(torch.int64))


def index_low_bits(x: torch.Tensor, n: int) -> torch.Tensor:
    """The canonical value mod n (a power of two <= 2^31) as int64
    indices (JAX ``index_low_bits``)."""
    assert n & (n - 1) == 0 and n <= 1 << 31
    return to_canonical(x) & (n - 1)


# --------------------------------------------------------------------------
# field ops
# --------------------------------------------------------------------------


def _canon(d: torch.Tensor) -> torch.Tensor:
    """(-p, p) -> [0, p): add p where negative (int32 or int64)."""
    return d + ((d >> (d.element_size() * 8 - 1)) & P)


def add(a, b):
    return _canon(a - (P - b))


def sub(a, b):
    return _canon(a - b)


def neg(a):
    return _canon(-a)


def mul(a, b):
    t = a.to(torch.int64) * b.to(torch.int64) % P
    return (t * RINV % P).to(DTYPE)


def mul_const(a, c: int):
    """Multiply by a host constant (broadcast)."""
    return (a.to(torch.int64) * (int(c) % P) % P).to(DTYPE)


def is_zero(a):
    return a == 0


def pow_const(a, e: int):
    """a^e for a host exponent (square-and-multiply)."""
    if e >= P - 1:
        e %= P - 1
    result = torch.full_like(a, R)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def inv(a):
    """Fermat inverse a^(p-2) (0 maps to 0, as in the JAX package)."""
    return pow_const(a, P - 2)


def batch_sum(a, axis: int = -1):
    """Sum along an axis: exact int64 sum of residues, one reduction (the
    Montgomery map is linear, so this is the sum's Montgomery form)."""
    assert a.shape[axis] < 1 << 32
    return (a.to(torch.int64).sum(dim=axis) % P).to(DTYPE)


def batch_prod(a, axis: int = -1):
    """Product along an axis as a log-depth pairwise tree."""
    x = torch.movedim(a, axis, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        s = mul(x[:half], x[half:2 * half])
        if x.shape[0] % 2:
            s = torch.cat([s, x[-1:]], dim=0)
        x = s
    return x[0]


def cumprod(a, axis: int = -1):
    """Inclusive prefix product along an axis (log-depth Hillis-Steele)."""
    x = torch.movedim(a, axis, 0)
    n = x.shape[0]
    k = 1
    while k < n:
        x = torch.cat([x[:k], mul(x[k:], x[:n - k])], dim=0)
        k *= 2
    return torch.movedim(x, 0, axis)


# -- PoW-grind helpers (``field/bb.py:212-227`` of the JAX package) ---------


def grind_set_lane(state, pos: int, cands):
    """Write canonical candidates (< 2^32) into state[:, pos], converted to
    Montgomery form."""
    out = state.clone()
    out[:, pos] = from_canonical(cands)
    return out


def grind_response_ok(resp, k: int):
    """canonical(resp) < 2^k for Montgomery-form responses."""
    if k >= 31:
        return torch.ones_like(resp, dtype=torch.bool)
    return to_canonical(resp) < (1 << k)
