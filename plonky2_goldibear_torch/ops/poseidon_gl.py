"""Poseidon-GL kernels (``csrc/poseidon_gl.cu``) and their plain torch
versions: the width-12 permutation, the leaf sponge and the Merkle levels.

Replaces the TPU kernels of ``plonky2_goldibear_tpu/ops/poseidon_gl.py``:
``permute_cols`` -> ``permute``, ``hash_cols_no_pad`` -> ``hash_leaves``,
``tree_tail_cols`` / ``build_levels_cols`` -> ``merkle_levels``.  On the
H100 all three are bound by integer instruction issue (a permutation is
118 S-boxes and 30 MDS layers against 192 bytes of state in and out).
The kernels keep each state in the registers of a group of 1, 2, 4 or 12
threads; ``group_for`` and ``merkle_plan`` pick the group and the block
size of each launch from the number of states and SMs, so that the
narrow Merkle levels still reach every SM (see the note in the source).
Layouts follow the JAX package's public functions: states (..., 12), leaf
rows (n, L), digest levels (w, 4) in natural node order.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; there is no other dispatch.  The plain versions
keep the reference's naive round schedule: they are the yardstick.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List

import numpy as np
import torch

from ..field import gl
from ..hash import _poseidon_gl_constants as C
from . import record

WIDTH = C.SPONGE_WIDTH          # 12
RATE = C.SPONGE_RATE            # 8
NUM_HASH_OUT = 4
HALF_FULL = C.HALF_N_FULL_ROUNDS
N_PARTIAL = C.N_PARTIAL_ROUNDS
N_ROUNDS = 2 * HALF_FULL + N_PARTIAL

launches = {"permute": 0, "leaf_sponge": 0, "merkle_levels": 0}

# Dense MDS matrix M[r, j] = CIRC[(j - r) mod 12] + (r == j) DIAG[r]
_MDS = np.zeros((WIDTH, WIDTH), dtype=np.int64)
for _r in range(WIDTH):
    for _j in range(WIDTH):
        _MDS[_r, _j] = C.MDS_MATRIX_CIRC[(_j - _r) % WIDTH]
    _MDS[_r, _r] += C.MDS_MATRIX_DIAG[_r]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@lru_cache(maxsize=8)
def _tables(device: str):
    rc = gl.from_ints(np.array(C.ALL_ROUND_CONSTANTS, dtype=np.uint64)
                      .reshape(N_ROUNDS, WIDTH), device)
    # the MDS transposed, as float64: its products with 32-bit limbs and
    # their sums are integers below 2^41, exact in a float64 matrix product
    return rc, torch.from_numpy(_MDS.T.astype(np.float64)).to(device)


# --------------------------------------------------------------------------
# plain torch versions
# --------------------------------------------------------------------------


def _sbox(x):
    x2 = gl.mul(x, x)
    x3, x4 = gl.mul(torch.stack([x2, x2]), torch.stack([x, x2]))  # one call
    return gl.mul(x3, x4)


def _mds(s, mt):
    """out[r] = sum_j M[r, j] s[j], as exact sums of 32-bit limbs (one
    float64 product by ``mt`` = M^T a limb: every sum < 2^41 < 2^53)."""
    lo = (s & gl.M32).to(torch.float64)
    hi = ((s >> 32) & gl.M32).to(torch.float64)
    acc_lo = (lo @ mt).to(torch.int64)        # < 264 * 2^32 < 2^41
    h = (hi @ mt).to(torch.int64) + (acc_lo >> 32)
    return gl._reduce128(acc_lo & gl.M32, h & gl.M32, h >> 32,
                         torch.zeros_like(h))


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """The width-12 Poseidon permutation on (..., 12), naive schedule."""
    rc, m = _tables(str(state.device))
    s = state
    for r in range(N_ROUNDS):
        s = gl.add(s, rc[r])
        if HALF_FULL <= r < HALF_FULL + N_PARTIAL:
            s = torch.cat([_sbox(s[..., :1]), s[..., 1:]], dim=-1)
        else:
            s = _sbox(s)
        s = _mds(s, m)
    return s


def hash_leaves_plain(inputs: torch.Tensor,
                      num_outputs: int = NUM_HASH_OUT) -> torch.Tensor:
    """Absorb each row (..., L) into a zero state in overwrite mode, 8 at a
    time (reference hash/hashing.rs:100-124); the first num_outputs lanes
    of the final state."""
    length = inputs.shape[-1]
    state = gl.zeros(inputs.shape[:-1] + (WIDTH,), inputs.device)
    for i in range(0, length, RATE):
        chunk = inputs[..., i:i + RATE]
        state = permute_plain(
            torch.cat([chunk, state[..., chunk.shape[-1]:]], dim=-1))
    return state[..., :num_outputs]


def _two_to_one_level_plain(cur: torch.Tensor) -> torch.Tensor:
    pairs = cur.reshape(-1, 2 * NUM_HASH_OUT)
    state = torch.cat([pairs, torch.zeros_like(pairs[:, :NUM_HASH_OUT])],
                      dim=-1)
    return permute_plain(state)[:, :NUM_HASH_OUT]


def merkle_levels_plain(d0: torch.Tensor, num_layers: int
                        ) -> List[torch.Tensor]:
    """Digests (n, 4) -> [level_1, ..., level_num_layers], level k of
    n >> k digests in natural node order (parent i of children 2i, 2i+1)."""
    levels = []
    cur = d0
    for _ in range(num_layers):
        cur = _two_to_one_level_plain(cur)
        levels.append(cur)
    return levels


# --------------------------------------------------------------------------
# launch geometry (pure functions of the shapes and the SM count)
# --------------------------------------------------------------------------

GROUPS = (1, 2, 4, 12)      # threads per state the kernels are built for
SPAN = {1: 1, 2: 2, 4: 4, 12: 16}   # threads a group occupies
FILL_PER_SM = 128           # threads per SM below which a launch takes a
                            # larger group (one warp per scheduler)
TAIL_PARENTS = 8            # a subtree's parents at the tail's first level
TAIL_MAX_LAYERS = TAIL_PARENTS.bit_length()   # 4; csrc/poseidon_gl.cu's


def group_for(states: int, sms: int) -> int:
    """Threads per state for a launch of ``states`` permutations: the
    fewest that still give FILL_PER_SM threads to every SM."""
    for g in GROUPS:
        if states * g >= FILL_PER_SM * sms:
            return g
    return GROUPS[-1]


def block_for(threads: int, sms: int) -> int:
    """Threads per block: 128, fewer (down to one warp) where that spreads
    the launch over more SMs."""
    return min(128, max(32, threads // sms // 32 * 32))


def merkle_plan(n: int, num_layers: int, sms: int) -> List[tuple]:
    """The launches of ``merkle_levels`` for n digests: ("level", parents,
    group, threads per block) one level each, then at most one ("tail",
    width, layers, subtrees, threads per block) for the top levels, once a
    subtree of the cap has at most TAIL_PARENTS parents at its first
    level."""
    plan = []
    width, left = n, num_layers
    while left > 0:
        parents = width // 2
        subtrees = width >> left
        if parents // subtrees <= TAIL_PARENTS:    # left <= TAIL_MAX_LAYERS
            plan.append(("tail", width, left, subtrees, 16 << (left - 1)))
            break
        g = group_for(parents, sms)
        plan.append(("level", parents, g, block_for(parents * SPAN[g], sms)))
        width, left = parents, left - 1
    return plan


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_CONSTANTS_SET = set()


def _lib(device):
    from . import _build

    lib = _build.lib("poseidon_gl")
    if device.index not in _CONSTANTS_SET:
        p64 = ctypes.POINTER(ctypes.c_uint64)
        lib.poseidon_gl_set_constants.argtypes = [p64]
        rc = np.array(C.ALL_ROUND_CONSTANTS, dtype=np.uint64)
        with torch.cuda.device(device):
            err = lib.poseidon_gl_set_constants(rc.ctypes.data_as(p64))
        _build.check(err, "poseidon_gl_set_constants")
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.poseidon_gl_permute.argtypes = [vp, vp, ll, vp]
        lib.poseidon_gl_leaf_sponge.argtypes = [vp, vp, ll, i32, i32, i32,
                                                i32, vp]
        lib.poseidon_gl_merkle_level.argtypes = [vp, vp, ll, i32, i32, vp]
        lib.poseidon_gl_merkle_tail.argtypes = [vp, vp, i32, i32, vp]
        assert lib.poseidon_gl_tail_max_layers() == TAIL_MAX_LAYERS
        _CONSTANTS_SET.add(device.index)
    return lib


@lru_cache(maxsize=8)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.int64:
        raise TypeError(f"{what} needs int64 field tensors, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def permute(state: torch.Tensor) -> torch.Tensor:
    """Batched permutation of states (..., 12)."""
    if state.shape[-1] != WIDTH:
        raise ValueError(f"permute needs (..., 12) states, got {state.shape}")
    if _on_cpu(state, "permute"):
        return permute_plain(state)
    from . import _build

    state = state.contiguous()
    _check_cuda(state, "permute")
    out = torch.empty_like(state)
    n = state.numel() // WIDTH
    record("permute", n)
    err = _lib(state.device).poseidon_gl_permute(
        state.data_ptr(), out.data_ptr(), n, _build.stream_ptr(state.device))
    _build.check(err, "poseidon_gl_permute")
    launches["permute"] += 1
    return out


def hash_leaves(inputs: torch.Tensor,
                num_outputs: int = NUM_HASH_OUT) -> torch.Tensor:
    """Sponge of each leaf row (n, L) -> (n, num_outputs) as
    ``hash_leaves_plain``: L >= 1, num_outputs <= 12."""
    if inputs.ndim != 2 or inputs.shape[1] == 0 or num_outputs > WIDTH:
        raise ValueError(f"hash_leaves needs (n, L>0) rows and at most "
                         f"{WIDTH} outputs, got {tuple(inputs.shape)}, "
                         f"{num_outputs}")
    if _on_cpu(inputs, "hash_leaves"):
        return hash_leaves_plain(inputs, num_outputs)
    inputs = inputs.contiguous()
    _check_cuda(inputs, "hash_leaves")
    record("leaf_sponge", *inputs.shape, num_outputs)
    return _sponge(inputs, num_outputs,
                   group_for(inputs.shape[0], _sms(inputs.device)))


def _sponge(inputs: torch.Tensor, num_outputs: int,
            group: int) -> torch.Tensor:
    """One sponge launch on the card, ``group`` threads per leaf."""
    from . import _build

    n, length = inputs.shape
    out = torch.empty((n, num_outputs), dtype=torch.int64,
                      device=inputs.device)
    err = _lib(inputs.device).poseidon_gl_leaf_sponge(
        inputs.data_ptr(), out.data_ptr(), n, length, num_outputs, group,
        block_for(n * SPAN[group], _sms(inputs.device)),
        _build.stream_ptr(inputs.device))
    _build.check(err, "poseidon_gl_leaf_sponge")
    launches["leaf_sponge"] += 1
    return out


def merkle_levels(d0: torch.Tensor, num_layers: int) -> List[torch.Tensor]:
    """Digest levels above d0 (n, 4), as ``merkle_levels_plain``, launched
    as ``merkle_plan`` says."""
    n = d0.shape[0]
    if d0.ndim != 2 or d0.shape[1] != NUM_HASH_OUT or \
            n & (n - 1) or n < (1 << num_layers):
        raise ValueError(f"merkle_levels needs (2^k, 4) digests with "
                         f"k >= {num_layers}, got {tuple(d0.shape)}")
    if _on_cpu(d0, "merkle_levels"):
        return merkle_levels_plain(d0, num_layers)
    d0 = d0.contiguous()
    _check_cuda(d0, "merkle_levels")
    record("merkle_levels", n, num_layers)
    return _levels(d0, merkle_plan(n, num_layers, _sms(d0.device)))


def _levels(d0: torch.Tensor, plan: List[tuple]) -> List[torch.Tensor]:
    """The launches of ``plan`` (as ``merkle_plan`` gives) on the card."""
    from . import _build

    lib = _lib(d0.device)
    stream = _build.stream_ptr(d0.device)
    levels = []
    cur = d0
    for step in plan:
        if step[0] == "level":
            _, parents, g, threads = step
            out = torch.empty((parents, NUM_HASH_OUT), dtype=torch.int64,
                              device=d0.device)
            err = lib.poseidon_gl_merkle_level(
                cur.data_ptr(), out.data_ptr(), parents, g, threads, stream)
            levels.append(out)
            cur = out
        else:
            _, width, layers, _, _ = step
            sizes = [width >> (k + 1) for k in range(layers)]
            out = torch.empty((sum(sizes), NUM_HASH_OUT), dtype=torch.int64,
                              device=d0.device)
            err = lib.poseidon_gl_merkle_tail(cur.data_ptr(), out.data_ptr(),
                                              width, layers, stream)
            levels.extend(torch.split(out, sizes, dim=0))
        _build.check(err, f"poseidon_gl_merkle_{step[0]}")
        launches["merkle_levels"] += 1
    return levels
