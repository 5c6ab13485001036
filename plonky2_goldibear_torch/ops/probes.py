"""Dependent-chain probes (``csrc/probes.cu``) and their plain torch
versions: one operation applied ``reps`` times to each element, y <- step(y,
x0) with y = x0 at the start.

Replaces the TPU probe kernels of ``scripts/`` (``profile_poseidon.py``
``_mulchain_kernel`` / ``_sboxchain_kernel``, ``profile_sbox2.py``
``_chain_kernel``, ``hwprobe3.py`` ``probe_u32`` / ``probe_gl`` /
``probe_sbox``, ``profile2.py`` ``_mulchain_kernel``).  They exist to be
timed (``plonky2_goldibear_torch.probes``), so a kernel is the chain and
nothing else: one thread per element, one load, one store.

Steps and how each is held:

=================  ==============================  ====================
step               one rep                         tensors
=================  ==============================  ====================
``gl_mul``         y <- y x0 (GL)                  int64 GL patterns
``gl_sqr``         y <- y y                        int64
``gl_sbox``        y <- y^7 = y^3 y^4              int64
``gl_sbox_serial`` y <- ((y y^2)^2) y              int64
``u32_mul``        y <- y x0 mod 2^32              int32 (u32 bits)
``u32_mul16``      y <- (y (x0 >> 16)) & 0xFFFF    int32 (u32 bits)
``u32_add``        y <- y + x0 mod 2^32            int32 (u32 bits)
``f32_fma``        y <- y x0 + 0.5                 float32
=================  ==============================  ====================

The GL steps keep values canonical (``field/gl.py``), as the port's
kernels do; the JAX chains are lazy (< 2^64), equal mod p.  The kernel
rounds ``f32_fma`` once (``fmaf``); the plain version forms y x0 + 0.5 in
float64 (the product exact) and rounds that to float32, which differs from
``fmaf`` only where the float64 sum itself rounded (products of 2^52 and
up), by one float32 rounding.  They agree within a relative 1e-5 at any
reps, an overflow to inf on one side only within it too (inf read as the
largest float); every other step agrees bit for bit.

``chain`` launches the kernel for a CUDA tensor and runs ``chain_plain``
for a CPU tensor; there is no other dispatch.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..field import gl
from .poseidon_gl import _sbox as _gl_sbox

M32 = 0xFFFFFFFF


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding any integer -> int32 with its low 32 bits."""
    return (((v + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def _gl_sbox_serial(y, _):
    t = gl.mul(y, y)
    t = gl.mul(t, y)
    t = gl.mul(t, t)
    return gl.mul(t, y)


def _u32_mul(y, x0):
    # signed 32-bit operands: the int64 product is exact (< 2^62) and has
    # the low 32 bits of the u32 product
    return _to_i32(y.long() * x0.long())


def _u32_mul16(y, x0):
    return _to_i32((y.long() * ((x0.long() & M32) >> 16)) & 0xFFFF)


def _u32_add(y, x0):
    return _to_i32(y.long() + x0.long())


def _f32_fma(y, x0):
    return (y.double() * x0.double() + 0.5).float()


# step -> (dtype, one rep of the plain version as f(y, x0))
STEPS = {
    "gl_mul": (torch.int64, gl.mul),
    "gl_sqr": (torch.int64, lambda y, _: gl.mul(y, y)),
    "gl_sbox": (torch.int64, lambda y, _: _gl_sbox(y)),
    "gl_sbox_serial": (torch.int64, _gl_sbox_serial),
    "u32_mul": (torch.int32, _u32_mul),
    "u32_mul16": (torch.int32, _u32_mul16),
    "u32_add": (torch.int32, _u32_add),
    "f32_fma": (torch.float32, _f32_fma),
}

launches = {"probe_" + step: 0 for step in STEPS}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(x: torch.Tensor, step: str, reps: int) -> None:
    if step not in STEPS:
        raise ValueError(f"unknown probe step {step!r}; one of {list(STEPS)}")
    if x.dtype != STEPS[step][0]:
        raise TypeError(f"probe {step} needs {STEPS[step][0]} tensors, got "
                        f"{x.dtype}")
    if not 0 <= reps < 1 << 31:
        raise ValueError(f"reps must be in [0, 2^31), got {reps}")


def chain_plain(x: torch.Tensor, step: str, reps: int) -> torch.Tensor:
    """y = x; reps times y = step(y, x); elementwise on any shape."""
    _check(x, step, reps)
    fn = STEPS[step][1]
    y = x
    for _ in range(reps):
        y = fn(y, x)
    return y.clone() if reps == 0 else y


@lru_cache(maxsize=1)
def _lib():
    from . import _build

    lib = _build.lib("probes")
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for step in STEPS:
        getattr(lib, "probe_" + step).argtypes = [vp, vp, ll, i32, vp]
    return lib


def unroll(step: str) -> int:
    """Steps in one pass of the step's kernel's main loop."""
    return getattr(_lib(), f"probe_{step}_unroll")()


def chain(x: torch.Tensor, step: str, reps: int) -> torch.Tensor:
    """The chain of ``chain_plain``: on a CUDA tensor one kernel launch."""
    _check(x, step, reps)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"chain: unsupported device {x.device}")
        return chain_plain(x, step, reps)
    from . import _build

    x = x.contiguous()
    out = torch.empty_like(x)
    err = getattr(_lib(), "probe_" + step)(
        x.data_ptr(), out.data_ptr(), x.numel(), reps,
        _build.stream_ptr(x.device))
    _build.check(err, "probe_" + step)
    launches["probe_" + step] += 1
    return out
