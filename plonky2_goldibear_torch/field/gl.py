"""Goldilocks arithmetic on torch tensors: p = 2^64 - 2^32 + 1.

A field array is an ``int64`` tensor holding the u64 bit pattern of a
canonical value (< p).  torch has no usable ``uint64`` arithmetic on the CPU
(add, sub, shifts and compares are not implemented for it), so:

- an unsigned compare flips the sign bit of both sides first (``_ult``);
- a right shift is arithmetic in int64, so every shift is masked;
- adds, subtracts and multiplies wrap mod 2^64, which is the u64
  arithmetic they mirror: ``mul`` takes the four 32x32-bit limb products
  (each below 2^64, so its int64 product holds all its bits) and sums them
  into the 128-bit product's two words.

Semantics match ``field/host.py`` python-int arithmetic and the JAX
package's ``field/gl.py`` bit for bit.  The same code runs on CPU and CUDA
tensors (it is plain elementwise torch).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..device import upload
from . import host

SPEC = host.GOLDILOCKS
P = SPEC.p                       # 0xFFFFFFFF00000001
EPS = (1 << 32) - 1              # 2^64 mod p  (== -p mod 2^64)
M32 = 0xFFFFFFFF
M16 = 0xFFFF
_MIN = -(1 << 63)                # sign bit
P_SIGNED = P - (1 << 64)         # p as an int64 bit pattern: -(2^32 - 1)
DTYPE = torch.int64


def to_signed(v: int) -> int:
    """Canonical python int (< 2^64) -> the int64 value with its bits."""
    v %= P
    return v - (1 << 64) if v >= 1 << 63 else v


# --------------------------------------------------------------------------
# construction / conversion
# --------------------------------------------------------------------------


def from_ints(vals: Union[Sequence[int], np.ndarray], device="cpu"
              ) -> torch.Tensor:
    """Host ints (canonical, < p) -> field tensor on ``device`` (to the
    card without blocking the host, ``device.upload``)."""
    a = np.ascontiguousarray(np.asarray(vals, dtype=np.uint64))
    return upload(a.view(np.int64).copy(), device)


def from_u32(w: torch.Tensor) -> torch.Tensor:
    """Integer tensor of values in [0, 2^32) -> field elements: the values
    themselves, canonical (the JAX package's ``field/gl.py:from_u32``)."""
    return w.to(DTYPE)


def flag(b: torch.Tensor) -> torch.Tensor:
    """A bool tensor as the field elements 1 and 0."""
    return from_u32(b.to(torch.int64))


def index_low_bits(x: torch.Tensor, n: int) -> torch.Tensor:
    """The canonical value mod n (a power of two <= 2^32) as int64
    indices: the low bits of the bit pattern (JAX ``index_low_bits``)."""
    assert n & (n - 1) == 0 and n <= 1 << 32
    return x & (n - 1)


def to_ints(x: torch.Tensor) -> np.ndarray:
    """Field tensor -> numpy uint64 canonical values (host sync)."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def zeros(shape, device="cpu") -> torch.Tensor:
    return torch.zeros(shape, dtype=DTYPE, device=device)


def ones(shape, device="cpu") -> torch.Tensor:
    return torch.ones(shape, dtype=DTYPE, device=device)


def full(shape, value: int, device="cpu") -> torch.Tensor:
    return torch.full(shape, to_signed(value), dtype=DTYPE, device=device)


# --------------------------------------------------------------------------
# u64 helpers on int64 bit patterns
# --------------------------------------------------------------------------


def _ult(a, b):
    """Unsigned a < b of two u64 bit patterns."""
    return (a ^ _MIN) < (b ^ _MIN)


def _geq_p(x):
    """x >= p (unsigned): exactly the patterns in [p, 2^64) = [P_SIGNED, -1]."""
    return (x < 0) & (x >= P_SIGNED)


def _canon(x):
    """[0, 2^64) -> [0, p): one conditional subtract of p."""
    return x + _geq_p(x).to(DTYPE) * EPS


def _reduce128(n0, n1, n2, n3):
    """(n3 2^96 + n2 2^64 + n1 2^32 + n0) mod p for 32-bit limbs, canonical.
    Uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p)."""
    return _reduce(n0 | (n1 << 32), n2, n3)


def _reduce(x, n2, n3):
    """(n3 2^96 + n2 2^64 + x) mod p for a u64 x and 32-bit n2, n3."""
    t0 = x - n3
    t0 = t0 - _ult(x, n3).to(DTYPE) * EPS       # borrow: add p back
    t1 = (n2 << 32) - n2                        # n2 (2^32 - 1) < 2^64
    t2 = t0 + t1
    t2 = t2 + _ult(t2, t0).to(DTYPE) * EPS      # carry: 2^64 = EPS
    return _canon(t2)


def _split(x):
    return x & M32, (x >> 32) & M32


# --------------------------------------------------------------------------
# field ops
# --------------------------------------------------------------------------


def _as_field(x, like: torch.Tensor):
    if isinstance(x, torch.Tensor):
        return x
    # a fill on the device: no host copy to wait for
    return torch.full((), to_signed(int(x)), dtype=DTYPE, device=like.device)


def add(a, b):
    s = a + b
    s = s + _ult(s, a).to(DTYPE) * EPS          # wrapped: 2^64 = EPS
    return _canon(s)


def sub(a, b):
    d = a - b
    return d - _ult(a, b).to(DTYPE) * EPS       # borrowed: + p


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul(a, b):
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    # the limb products' u64 bit patterns (int64 products wrap mod 2^64)
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = ((ll >> 32) & M32) + (lh & M32) + (hl & M32)     # < 3 * 2^32
    lo = (ll & M32) | (mid << 32)
    hi = hh + ((lh >> 32) & M32) + ((hl >> 32) & M32) + (mid >> 32)
    return _reduce(lo, hi & M32, (hi >> 32) & M32)


def mul_const(a, c: int):
    """Multiply by a host constant (broadcast)."""
    return mul(a, _as_field(c, a))


def is_zero(a):
    return a == 0


def pow_const(a, e: int):
    """a^e for a host exponent (square-and-multiply)."""
    if e >= P - 1:
        e %= P - 1
    result = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def _sqr_n(x, n: int):
    for _ in range(n):
        x = mul(x, x)
    return x


def inv(a):
    """Fermat inverse a^(p-2), p - 2 = (2^31 - 1) 2^33 + (2^32 - 1), by an
    addition chain of 64 squarings and 8 multiplies (square-and-multiply
    takes 125).  Callers ensure nonzero inputs (division by zero is a
    proving error, reference plonk/prover.rs:515)."""
    x2 = mul(_sqr_n(a, 1), a)              # a^(2^2 - 1)
    x3 = mul(_sqr_n(x2, 1), a)             # a^(2^3 - 1)
    x6 = mul(_sqr_n(x3, 3), x3)
    x12 = mul(_sqr_n(x6, 6), x6)
    x24 = mul(_sqr_n(x12, 12), x12)
    x30 = mul(_sqr_n(x24, 6), x6)
    x31 = mul(_sqr_n(x30, 1), a)
    x32 = mul(_sqr_n(x31, 1), a)
    return mul(_sqr_n(x31, 33), x32)


def batch_sum(a, axis: int = -1):
    """Sum along an axis: exact 32-bit limb sums in int64, one reduction."""
    lo, hi = _split(a)
    assert a.shape[axis] < 1 << 31
    s_lo = lo.sum(dim=axis)                     # < 2^63
    h = hi.sum(dim=axis) + (s_lo >> 32)         # < 2^63
    return _reduce128(s_lo & M32, h & M32, h >> 32, torch.zeros_like(h))


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
    """Inclusive prefix product along an axis (log-depth Hillis-Steele scan:
    log2(n) whole-array multiplies instead of n sequential ones)."""
    x = torch.movedim(a, axis, 0)
    n = x.shape[0]
    k = 1
    while k < n:
        x = torch.cat([x[:k], mul(x[k:], x[:n - k])], dim=0)
        k *= 2
    return torch.movedim(x, 0, axis)


# -- PoW-grind helpers -------------------------------------------------------


def grind_set_lane(state, pos: int, cands):
    """Write canonical candidates (< 2^32) into state[:, pos]."""
    out = state.clone()
    out[:, pos] = cands
    return out


def grind_response_ok(resp, k: int):
    """Canonical u64 value < 2^k."""
    if k >= 64:
        return torch.ones_like(resp, dtype=torch.bool)
    if k == 63:
        return resp >= 0
    return (resp >= 0) & (resp < (1 << k))
