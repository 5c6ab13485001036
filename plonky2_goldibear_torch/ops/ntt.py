"""Batched NTT: the Goldilocks CUDA kernel ``csrc/ntt_gl.cu``, and the
plain torch versions of both fields' kernels.

Replaces the TPU kernel ``plonky2_goldibear_tpu/ops/ntt.py:_fft_fused``
(with ``_fft_four_step`` above 2^16).  On the H100 the transform is bound
by its butterflies (a ``gl::mul`` each), not by device memory: a row of
up to 2^15 takes one launch in the shared memory of a thread-block
cluster (``csrc/ntt_cluster.cuh``; the plan, the launch and the plain
replay ``fft_by_cluster`` are ``ops/ntt_bb.py``'s, shared by both
fields).  Longer rows take a coalesced bit-reversal launch and then the
passes of ``csrc/ntt.cuh``: a 32 KB tile in shared memory runs every stage
it spans before writing back, so they cost ceil(n / LOG_TILE) passes.

``fft(x, zero_prefix_log)`` launches the kernels for a CUDA tensor and
runs ``fft_plain`` for a CPU tensor; there is no other dispatch.
``fft_by_passes`` replays the pass decomposition in plain torch so the CPU
tests check its index arithmetic.  The plain functions take the field
module ``F`` (``gl`` or ``bb``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Tuple

import torch

from ..field import gl, host
from . import record

LOG_TILE = 12           # Goldilocks' pass tile; must match csrc/ntt_gl.cu
launches = 0            # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


@lru_cache(maxsize=64)
def _bitrev_perm(n_log: int, device: str) -> torch.Tensor:
    i = torch.arange(1 << n_log, dtype=torch.int64)
    r = torch.zeros_like(i)
    for _ in range(n_log):
        r = (r << 1) | (i & 1)
        i = i >> 1
    return r.to(device)


def reverse_index_bits(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n = x.shape[dim]
    perm = _bitrev_perm(host.log2_strict(n), str(x.device))
    return torch.index_select(x, dim, perm)


def powers(base: int, n: int, device, F=gl) -> torch.Tensor:
    """[1, b, ..., b^(n-1)] for a host constant b (log-depth scan)."""
    if n == 0:
        return F.zeros((0,), device)
    body = F.cumprod(F.full((n - 1,), base, device), axis=0)
    return torch.cat([F.ones((1,), device), body])


@lru_cache(maxsize=32)
def twiddles(n_log: int, device: str, F=gl) -> torch.Tensor:
    """tw[(1 << s) - 1 + i] = w_{2^(s+1)}^i for s < n_log, i < 2^s (the
    rows of the reference's fft_root_table, field/src/fft.rs:12-31), in
    ``F``'s representation (Montgomery form for BabyBear)."""
    if n_log == 0:
        return F.zeros((1,), device)
    top = powers(F.SPEC.two_adic_generator(n_log), 1 << (n_log - 1),
                 device, F)
    rows = [top[::1 << (n_log - 1 - s)] for s in range(n_log)]
    return torch.cat(rows).contiguous()


def pass_plan(n_log: int, tile_log: int = LOG_TILE) -> List[Tuple[int, int]]:
    """Stage ranges [s0, s1) of the kernel's passes."""
    return [(s0, min(s0 + tile_log, n_log))
            for s0 in range(0, n_log, tile_log)]


# --------------------------------------------------------------------------
# plain torch versions
# --------------------------------------------------------------------------


def _bitrev_load(x: torch.Tensor, r: int) -> torch.Tensor:
    """Position g of the first pass's tile holds x[rev(g >> r)]."""
    n = x.shape[-1]
    n_log = host.log2_strict(n)
    small = reverse_index_bits(x[..., :n >> r], dim=-1)
    return small.repeat_interleave(1 << r, dim=-1) if r else small


def fft_plain(x: torch.Tensor, zero_prefix_log: int = 0, F=gl
              ) -> torch.Tensor:
    """Radix-2 DIT NTT over the last axis, one torch pass per stage."""
    n = x.shape[-1]
    n_log = host.log2_strict(n)
    batch = x.shape[:-1]
    r = zero_prefix_log
    y = _bitrev_load(x, r)
    tw = twiddles(n_log, str(x.device), F)
    for s in range(r, n_log):
        half = 1 << s
        yv = y.reshape(batch + (n // (2 * half), 2, half))
        t = F.mul(yv[..., 1, :], tw[half - 1:2 * half - 1])
        even = yv[..., 0, :]
        y = torch.stack([F.add(even, t), F.sub(even, t)],
                        dim=-2).reshape(batch + (n,))
    return y


def fft_by_passes(x: torch.Tensor, zero_prefix_log: int = 0,
                  tile_log: int = LOG_TILE, F=gl) -> torch.Tensor:
    """The schedule of rows above 2^15 in plain torch: the bit-reversal,
    then passes of ``pass_plan``, each over (column, k) tiles with index
    j + (k << s0) + (h << s1)."""
    n = x.shape[-1]
    n_log = host.log2_strict(n)
    batch = x.shape[:-1]
    r = zero_prefix_log
    y = _bitrev_load(x, r)
    tw = twiddles(n_log, str(x.device), F)
    for s0, s1 in pass_plan(n_log, tile_log):
        # view as (batch, h, k, j): k spans the pass's stages
        v = y.reshape(batch + (n >> s1, 1 << (s1 - s0), 1 << s0))
        j = torch.arange(1 << s0, device=x.device)
        for s in range(max(s0, r), s1):
            ls = s - s0
            half = 1 << ls
            kk = v.shape[-2]
            vv = v.reshape(batch + (n >> s1, kk // (2 * half), 2, half,
                                    1 << s0))
            kr = torch.arange(half, device=x.device)
            w = tw[(1 << s) - 1 + j[None, :] + (kr[:, None] << s0)]
            a = vv[..., 0, :, :]
            b = F.mul(vv[..., 1, :, :], w)
            v = torch.stack([F.add(a, b), F.sub(a, b)], dim=-3).reshape(
                v.shape)
        y = v.reshape(batch + (n,))
    return y


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def pass_fn(lib_name: str):
    """The pass kernel ``<lib_name>_pass`` of ``csrc/<lib_name>.cu``, its C
    signature set once."""
    from . import _build

    fn = getattr(_build.lib(lib_name), lib_name + "_pass")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def check_input(x: torch.Tensor, F) -> bool:
    """Validate an fft input; True when the transform is the identity."""
    if x.dtype != F.DTYPE:
        raise TypeError(f"fft needs {F.DTYPE} field tensors, got {x.dtype}")
    n = x.shape[-1]
    host.log2_strict(n)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fft: unsupported device {x.device}")
    return n == 1 or x.numel() == 0


def fft(x: torch.Tensor, zero_prefix_log: int = 0) -> torch.Tensor:
    """Forward NTT over the last axis of (..., N), natural order in and out:
    ``fft(c)[k] = sum_i c_i g^(ik)``, g of order N.  ``zero_prefix_log`` = r
    declares that only the first N / 2^r coefficients may be nonzero."""
    from . import ntt_bb

    global launches
    if check_input(x, gl):
        return x.clone()
    n_log = x.shape[-1].bit_length() - 1
    if not 0 <= zero_prefix_log <= n_log:
        raise ValueError(f"fft: zero_prefix_log {zero_prefix_log} outside "
                         f"[0, {n_log}]")
    if x.is_cuda:
        record("ntt", x.numel() // x.shape[-1], x.shape[-1], zero_prefix_log)
        out, k = ntt_bb.launch(x, zero_prefix_log, gl)
        launches += k
        return out
    return fft_plain(x, zero_prefix_log)
