"""NTT / iFFT / coset LDE over the two-adic fields, batched over leading
axes, generic over the torch field module ``F`` (``gl`` or ``bb``; the
Goldilocks module by default).

Conventions (the reference's, field/src/fft.rs:50-94):
- ``fft(coeffs)[k] = p(g^k)`` with g = two_adic_generator(log n), natural
  order in and out.
- ``ifft`` = forward fft + index reversal (k -> n - k) + scale by n^-1.
- ``coset_fft(coeffs, shift)``: evaluations on the coset shift * <g>.
- ``lde_coset_fft``: zero-pad by 2^rate_bits then coset-fft on the
  generator coset, with the padding virtual: the NTT skips its first
  rate_bits stages (field/src/fft.rs:168-205).

Every transform goes through ``ops/ntt.py:fft`` (Goldilocks) or
``ops/ntt_bb.py:fft`` (BabyBear): the CUDA kernel for a CUDA tensor, its
plain version for a CPU tensor.  Extension values are tuples of base
tensors; their transforms are componentwise, and each is one batched call
over the D components stacked.  The coset power tables are cached per
(base, n, device, field).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..ops import ntt as ntt_ops
from ..ops import ntt_bb as ntt_bb_ops
from . import gl, host

reverse_index_bits = ntt_ops.reverse_index_bits
powers = ntt_ops.powers


def fft(x: torch.Tensor, zero_prefix_log: int = 0, F=gl) -> torch.Tensor:
    """Forward NTT over the last axis of (..., n)."""
    ops = ntt_ops if F is gl else ntt_bb_ops
    return ops.fft(x, zero_prefix_log)


def ifft(x: torch.Tensor, F=gl) -> torch.Tensor:
    """Inverse NTT: values (..., n) -> coefficients."""
    n = x.shape[-1]
    y = fft(x, F=F)
    idx = (n - torch.arange(n, device=x.device)) & (n - 1)
    return F.mul_const(y[..., idx], host.finv(n, F.P))


@lru_cache(maxsize=64)
def _coset_powers(base: int, n: int, device: str, F) -> torch.Tensor:
    return powers(base, n, device, F)


def coset_powers(base: int, n: int, device, F=gl) -> torch.Tensor:
    """``powers(base, n)``, built once per (base, n, device, field); callers
    must not write to it."""
    return _coset_powers(base, n, str(torch.device(device)), F)


def coset_fft(coeffs: torch.Tensor, shift: int, F=gl) -> torch.Tensor:
    """Evaluations on the coset shift * <g>: fft(shift^i c_i)."""
    n = coeffs.shape[-1]
    return fft(F.mul(coeffs, coset_powers(shift, n, coeffs.device, F)), F=F)


def coset_ifft(values: torch.Tensor, shift: int, F=gl) -> torch.Tensor:
    """Inverse of coset_fft."""
    n = values.shape[-1]
    coeffs = ifft(values, F)
    shift_inv = host.finv(shift % F.P, F.P)
    return F.mul(coeffs, coset_powers(shift_inv, n, values.device, F))


def lde_coset_fft(coeffs: torch.Tensor, rate_bits: int, F=gl
                  ) -> torch.Tensor:
    """Low-degree extension (num_polys, n) -> (num_polys, n << rate_bits) on
    the generator coset (the PolynomialBatch commit path, reference
    fri/oracle.rs:125-150)."""
    n = coeffs.shape[-1]
    scaled = F.mul(coeffs, coset_powers(F.SPEC.coset_shift, n, coeffs.device,
                                        F))
    padded = torch.nn.functional.pad(scaled, (0, (n << rate_bits) - n))
    return fft(padded, zero_prefix_log=rate_bits, F=F)


# -- extension-field transforms (componentwise over the base field) ---------
# The D component arrays are stacked on a new leading axis, transformed in
# one batched call, and split again.


def ext_fft(x, F=gl):
    return tuple(fft(torch.stack(x), F=F).unbind(0))


def ext_ifft(x, F=gl):
    return tuple(ifft(torch.stack(x), F).unbind(0))


def ext_coset_fft(x, shift: int, F=gl):
    return tuple(coset_fft(torch.stack(x), shift, F).unbind(0))


def ext_coset_ifft(x, shift: int, F=gl):
    return tuple(coset_ifft(torch.stack(x), shift, F).unbind(0))
