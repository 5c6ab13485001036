"""Batched BabyBear NTT: the CUDA kernel ``csrc/ntt_bb.cu`` and its plain
torch version.

Replaces the TPU kernel ``plonky2_goldibear_tpu/ops/ntt_bb.py:_fft_fused``
(with ``_fft_four_step`` above 2^16).  Values and twiddles are u32
Montgomery forms (``field/bb.py``); the butterfly is one Montgomery product
with a canonical add and subtract, and no value leaves [0, p).  The kernel
runs the schedule of ``csrc/ntt.cuh`` (the Goldilocks kernel's) on tiles
of 2^13 u32: one code path for every size, one pass up to 2^13, two up to
2^26.

``fft(x, zero_prefix_log)`` launches the kernel for a CUDA tensor and runs
``fft_plain`` for a CPU tensor; there is no other dispatch and no size
threshold (the FRI final polynomial goes to the kernel too).
"""

from __future__ import annotations

import torch

from ..field import bb
from . import ntt, record

LOG_TILE = 13           # must match ntt_bb_pass in csrc/ntt_bb.cu
launches = 0            # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


def fft_plain(x: torch.Tensor, zero_prefix_log: int = 0) -> torch.Tensor:
    """Radix-2 DIT NTT over the last axis, one torch pass per stage."""
    return ntt.fft_plain(x, zero_prefix_log, bb)


def fft_by_passes(x: torch.Tensor, zero_prefix_log: int = 0,
                  tile_log: int = LOG_TILE) -> torch.Tensor:
    """The kernel's pass schedule in plain torch."""
    return ntt.fft_by_passes(x, zero_prefix_log, tile_log, bb)


def fft(x: torch.Tensor, zero_prefix_log: int = 0) -> torch.Tensor:
    """Forward NTT over the last axis of a BabyBear tensor (..., N), natural
    order in and out; ``zero_prefix_log`` = r declares that only the first
    N / 2^r coefficients may be nonzero."""
    global launches
    if ntt.check_input(x, bb):
        return x.clone()
    if x.is_cuda:
        record("ntt_bb", x.numel() // x.shape[-1], x.shape[-1],
               zero_prefix_log)
        out, k = ntt.launch_passes(x.contiguous(), zero_prefix_log, bb,
                                   "ntt_bb", LOG_TILE)
        launches += k
        return out
    return fft_plain(x, zero_prefix_log)
