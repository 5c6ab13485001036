"""Poseidon2-BabyBear kernels (``csrc/poseidon2_bb.cu``) and their plain
torch versions: the width-16 permutation, the leaf sponge and the Merkle
levels.

Replaces the TPU kernel ``plonky2_goldibear_tpu/ops/poseidon2_bb.py:
permute_cols``, which the JAX package reaches once per absorb of the leaf
sponge, once per Merkle level and once per PoW-grind batch.  On the H100
the permutation is bound by integer multiplies (about 1000 Montgomery
products per 64 bytes of state in and out).  Each kernel keeps a state in
16 registers of one thread for the whole permutation (and, in the sponge,
across all absorbs of a leaf), with the round constants in constant
memory.  Layouts follow the JAX package's public functions: states
(..., 16), leaf rows (n, L), digest levels (w, 8) in natural node order;
all values are BabyBear Montgomery forms (``field/bb.py``).

The plain round functions work on a lanes-first state (16, ...), the
layout ``gates/poseidon2_bb_gate.py`` evaluates its constraints in.  They
use that the Montgomery map is linear: the external layer's small-integer
matrix, the internal layer's scale and 2^shift diagonal are integer sums
and products reduced once mod p.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; there is no other dispatch.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List

import numpy as np
import torch

from ..field import bb
from ..hash import _poseidon2_bb_constants as C
from . import record

WIDTH = C.SPONGE_WIDTH          # 16
RATE = C.SPONGE_RATE            # 8
NUM_HASH_OUT = 8
HALF_FULL = C.HALF_N_FULL_ROUNDS
N_PARTIAL = C.N_PARTIAL_ROUNDS
N_FULL = C.N_FULL_ROUNDS_TOTAL
TAIL_W = 512                    # must match csrc/poseidon2_bb.cu

launches = {"p2_permute": 0, "p2_leaf_sponge": 0, "p2_merkle_levels": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@lru_cache(maxsize=8)
def _tables(device: str):
    """Round constants in Montgomery form: external (8, 16, 1), internal
    (13,)."""
    ext = bb.from_ints(np.array(C.EXTERNAL_CONSTANTS, dtype=np.uint64),
                       device)[:, :, None]
    internal = bb.from_ints(np.array(C.INTERNAL_CONSTANTS, dtype=np.uint64),
                            device)
    return ext, internal


# --------------------------------------------------------------------------
# plain torch versions (lanes-first state (16, ...))
# --------------------------------------------------------------------------


def sbox(x):
    x2 = bb.mul(x, x)
    return bb.mul(bb.mul(x2, x), bb.mul(x2, x2))


def external_layer(st: torch.Tensor) -> torch.Tensor:
    """Blockwise M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]], then each
    lane plus the sum of its congruence class over the four blocks
    (reference gates/poseidon2_babybear.rs:903-995)."""
    x = st.to(torch.int64).reshape((WIDTH // 4, 4) + st.shape[1:])
    x0, x1, x2, x3 = x.unbind(1)
    t0123 = x0 + x1 + x2 + x3
    y = torch.stack([t0123 + x0 + 2 * x1, t0123 + x1 + 2 * x2,
                     t0123 + x2 + 2 * x3, t0123 + x3 + 2 * x0], dim=1)
    return ((y + y.sum(0, keepdim=True)) % bb.P).to(bb.DTYPE).reshape(
        st.shape)


def internal_layer(st: torch.Tensor) -> torch.Tensor:
    """Scale every lane by INTERNAL_SCALE; head = sum(lanes 1..15) - lane 0,
    lane i = sum(all lanes) + lane i * 2^shift_(i-1) (reference
    permute_internal_mut, gates/poseidon2_babybear.rs:787-803)."""
    s = st.to(torch.int64) * C.INTERNAL_SCALE % bb.P
    part = s[1:].sum(0)
    shifts = torch.tensor([1 << k for k in C.INTERNAL_DIAG_SHIFTS],
                          dtype=torch.int64, device=st.device)
    shifts = shifts.reshape((WIDTH - 1,) + (1,) * (st.dim() - 1))
    head = part - s[0] + bb.P
    tail = part + s[0] + s[1:] * shifts
    return (torch.cat([head[None], tail]) % bb.P).to(bb.DTYPE)


def full_round(st: torch.Tensor, r: int) -> torch.Tensor:
    ext, _ = _tables(str(st.device))
    rc = ext[r].reshape((WIDTH,) + (1,) * (st.dim() - 1))
    return external_layer(sbox(bb.add(st, rc)))


def partial_round(st: torch.Tensor, r: int) -> torch.Tensor:
    _, internal = _tables(str(st.device))
    s0 = sbox(bb.add(st[0], internal[r]))
    return internal_layer(torch.cat([s0[None], st[1:]]))


def permute_lanes(st: torch.Tensor) -> torch.Tensor:
    """The permutation on a lanes-first state (16, ...)."""
    st = external_layer(st)
    for r in range(HALF_FULL):
        st = full_round(st, r)
    for r in range(N_PARTIAL):
        st = partial_round(st, r)
    for r in range(HALF_FULL, N_FULL):
        st = full_round(st, r)
    return st


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """The width-16 Poseidon2 permutation on states (..., 16)."""
    return torch.movedim(permute_lanes(torch.movedim(state, -1, 0)), 0, -1)


def hash_leaves_plain(inputs: torch.Tensor,
                      num_outputs: int = NUM_HASH_OUT) -> torch.Tensor:
    """Absorb each row (..., L) into a zero state in overwrite mode, 8 at a
    time; the first num_outputs lanes of the final state."""
    length = inputs.shape[-1]
    state = bb.zeros(inputs.shape[:-1] + (WIDTH,), inputs.device)
    for i in range(0, length, RATE):
        chunk = inputs[..., i:i + RATE]
        state = permute_plain(
            torch.cat([chunk, state[..., chunk.shape[-1]:]], dim=-1))
    return state[..., :num_outputs]


def merkle_levels_plain(d0: torch.Tensor, num_layers: int
                        ) -> List[torch.Tensor]:
    """Digests (n, 8) -> [level_1, ..., level_num_layers], level k of
    n >> k digests in natural node order: parent i is the first 8 lanes of
    the permutation of (child 2i || child 2i + 1)."""
    levels = []
    cur = d0
    for _ in range(num_layers):
        cur = permute_plain(cur.reshape(-1, WIDTH))[:, :NUM_HASH_OUT]
        levels.append(cur)
    return levels


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_CONSTANTS_SET = set()


def _mont_array(vals) -> np.ndarray:
    a = np.asarray(vals, dtype=np.uint64).reshape(-1) % np.uint64(bb.P)
    return ((a * np.uint64(bb.R)) % np.uint64(bb.P)).astype(np.uint32)


def _lib(device):
    from . import _build

    lib = _build.lib("poseidon2_bb")
    if device.index not in _CONSTANTS_SET:
        p32 = ctypes.POINTER(ctypes.c_uint32)
        lib.poseidon2_bb_set_constants.argtypes = [p32] * 4
        ext = _mont_array(C.EXTERNAL_CONSTANTS)
        internal = _mont_array(C.INTERNAL_CONSTANTS)
        scale = _mont_array([C.INTERNAL_SCALE])
        shifts = _mont_array([1 << k for k in C.INTERNAL_DIAG_SHIFTS])
        with torch.cuda.device(device):
            err = lib.poseidon2_bb_set_constants(
                ext.ctypes.data_as(p32), internal.ctypes.data_as(p32),
                scale.ctypes.data_as(p32), shifts.ctypes.data_as(p32))
        _build.check(err, "poseidon2_bb_set_constants")
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.poseidon2_bb_permute.argtypes = [vp, vp, ll, vp]
        lib.poseidon2_bb_leaf_sponge.argtypes = [vp, vp, ll, i32, i32, vp]
        lib.poseidon2_bb_merkle_level.argtypes = [vp, vp, ll, vp]
        lib.poseidon2_bb_merkle_tail.argtypes = [vp, vp, i32, i32, vp]
        assert lib.poseidon2_bb_tail_width() == TAIL_W
        _CONSTANTS_SET.add(device.index)
    return lib


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.dtype != bb.DTYPE:
        raise TypeError(f"{what} needs int32 BabyBear tensors, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def permute(state: torch.Tensor) -> torch.Tensor:
    """Batched permutation of states (..., 16), any batch size."""
    if state.shape[-1] != WIDTH:
        raise ValueError(f"permute needs (..., 16) states, got {state.shape}")
    if _on_cpu(state, "permute"):
        return permute_plain(state)
    from . import _build

    state = state.contiguous()
    _check_cuda(state, "permute")
    out = torch.empty_like(state)
    n = state.numel() // WIDTH
    record("p2_permute", n)
    err = _lib(state.device).poseidon2_bb_permute(
        state.data_ptr(), out.data_ptr(), n, _build.stream_ptr(state.device))
    _build.check(err, "poseidon2_bb_permute")
    launches["p2_permute"] += 1
    return out


def hash_leaves(inputs: torch.Tensor,
                num_outputs: int = NUM_HASH_OUT) -> torch.Tensor:
    """Sponge of each leaf row (n, L) -> (n, num_outputs) as
    ``hash_leaves_plain``: L >= 1, num_outputs <= 16.  All absorbs of a row
    run in one thread (the JAX package launches one permutation per
    absorb); the output is the same."""
    if inputs.ndim != 2 or inputs.shape[1] == 0 or num_outputs > WIDTH:
        raise ValueError(f"hash_leaves needs (n, L>0) rows and at most "
                         f"{WIDTH} outputs, got {tuple(inputs.shape)}, "
                         f"{num_outputs}")
    if _on_cpu(inputs, "hash_leaves"):
        return hash_leaves_plain(inputs, num_outputs)
    from . import _build

    inputs = inputs.contiguous()
    _check_cuda(inputs, "hash_leaves")
    n, length = inputs.shape
    record("p2_leaf_sponge", n, length, num_outputs)
    out = torch.empty((n, num_outputs), dtype=bb.DTYPE, device=inputs.device)
    err = _lib(inputs.device).poseidon2_bb_leaf_sponge(
        inputs.data_ptr(), out.data_ptr(), n, length, num_outputs,
        _build.stream_ptr(inputs.device))
    _build.check(err, "poseidon2_bb_leaf_sponge")
    launches["p2_leaf_sponge"] += 1
    return out


def merkle_levels(d0: torch.Tensor, num_layers: int) -> List[torch.Tensor]:
    """Digest levels above d0 (n, 8), as ``merkle_levels_plain``.  Levels
    wider than TAIL_W digests are one launch each; the rest one launch."""
    n = d0.shape[0]
    if d0.ndim != 2 or d0.shape[1] != NUM_HASH_OUT or \
            n & (n - 1) or n < (1 << num_layers):
        raise ValueError(f"merkle_levels needs (2^k, 8) digests with "
                         f"k >= {num_layers}, got {tuple(d0.shape)}")
    if _on_cpu(d0, "merkle_levels"):
        return merkle_levels_plain(d0, num_layers)
    from . import _build

    d0 = d0.contiguous()
    _check_cuda(d0, "merkle_levels")
    record("p2_merkle_levels", n, num_layers)
    lib = _lib(d0.device)
    stream = _build.stream_ptr(d0.device)
    levels = []
    cur = d0
    layers_left = num_layers
    while layers_left > 0 and cur.shape[0] > TAIL_W:
        parents = cur.shape[0] // 2
        out = torch.empty((parents, NUM_HASH_OUT), dtype=bb.DTYPE,
                          device=d0.device)
        err = lib.poseidon2_bb_merkle_level(cur.data_ptr(), out.data_ptr(),
                                            parents, stream)
        _build.check(err, "poseidon2_bb_merkle_level")
        launches["p2_merkle_levels"] += 1
        levels.append(out)
        cur = out
        layers_left -= 1
    if layers_left > 0:
        width = cur.shape[0]
        sizes = [width >> (k + 1) for k in range(layers_left)]
        out = torch.empty((sum(sizes), NUM_HASH_OUT), dtype=bb.DTYPE,
                          device=d0.device)
        err = lib.poseidon2_bb_merkle_tail(cur.data_ptr(), out.data_ptr(),
                                           width, layers_left, stream)
        _build.check(err, "poseidon2_bb_merkle_tail")
        launches["p2_merkle_levels"] += 1
        levels.extend(torch.split(out, sizes, dim=0))
    return levels
