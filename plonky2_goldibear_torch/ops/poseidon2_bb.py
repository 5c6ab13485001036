"""Poseidon2-BabyBear kernels (``csrc/poseidon2_bb.cu``) and their plain
torch versions: the width-16 permutation, the leaf sponge and the Merkle
levels.

Replaces the TPU kernel ``plonky2_goldibear_tpu/ops/poseidon2_bb.py:
permute_cols``, which the JAX package reaches once per absorb of the leaf
sponge, once per Merkle level and once per PoW-grind batch.  On the H100
the permutation is bound by integer multiplies (785 Montgomery products
per 64 bytes of state in and out).  The permutation and the sponge keep a
state in 16 registers of one thread for the whole permutation (and, in
the sponge, across all absorbs of a leaf), with the round constants in
constant memory.  The sponge holds a state in a group of 1, 4 or 16
threads across all absorbs of its leaf, the group chosen per launch by
``sponge_plan`` (one thread where the leaves fill the card, more for the
narrow FRI layers).  The wide Merkle levels hold a state in one thread or
a group of 4; the narrow ones run as subtrees, one block each, 16 threads
a parent, the top ones one block per cap node; ``group_for`` and
``merkle_plan`` pick the launches from the number of states and SMs (see
the note in the source).
Layouts follow the JAX package's public functions: states
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
from typing import List, Sequence, Tuple

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


@lru_cache(maxsize=8)
def _shifts(device: str) -> torch.Tensor:
    """2^shift_(i-1) of lanes 1..15, on ``device`` once (no copy a call)."""
    return torch.tensor([1 << k for k in C.INTERNAL_DIAG_SHIFTS],
                        dtype=torch.int64, device=device)


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
    shifts = _shifts(str(st.device)).reshape((WIDTH - 1,)
                                             + (1,) * (st.dim() - 1))
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
# launch geometry of the Merkle levels (pure functions of the shapes and
# the SM count)
# --------------------------------------------------------------------------

GROUPS = (1, 4)             # threads per state the level kernel is built for
FILL_PER_SM = 128           # threads per SM below which a level takes a
                            # larger group (one warp per scheduler)
SUBTREE_GROUP = 16          # threads per parent in a subtree launch
SUBTREE_MAX_LAYERS = 5      # levels a subtree launch folds; the source's
SPONGE_GROUPS = (1, 4, 16)  # threads per state the sponge is built for
SPONGE_FILL_PER_SM = 64     # as FILL_PER_SM, for the sponge's groups


def group_for(states: int, sms: int, groups=GROUPS,
              fill: int = FILL_PER_SM) -> int:
    """Threads per state for a launch of ``states`` permutations: the
    fewest of ``groups`` that still give ``fill`` threads to every SM, else
    the most."""
    for g in groups:
        if states * g >= fill * sms:
            return g
    return groups[-1]


def block_for(threads: int, sms: int) -> int:
    """Threads per block: 128, fewer (down to one warp) where that spreads
    the launch over more SMs."""
    return min(128, max(32, threads // sms // 32 * 32))


@lru_cache(maxsize=256)
def sponge_plan(n: int, sms: int) -> Tuple[int, int]:
    """(threads per state, threads per block) of the sponge of n leaves."""
    g = group_for(n, sms, SPONGE_GROUPS, SPONGE_FILL_PER_SM)
    return g, block_for(n * g, sms)


@lru_cache(maxsize=256)
def merkle_plan(n: int, num_layers: int, sms: int) -> Tuple[tuple, ...]:
    """The launches of ``merkle_levels`` for n digests: ("level", parents,
    group, threads per block) for each level whose largest group still
    fills the card (FILL_PER_SM threads an SM), then the narrower levels as
    ("subtree", width, layers, subtrees, threads per block) launches of at
    most SUBTREE_MAX_LAYERS levels, one block per subtree, the deepest at
    the top (the tail: one block per node of the cap)."""
    plan = []
    width, left = n, num_layers
    while left > 0 and (width // 2) * GROUPS[-1] >= FILL_PER_SM * sms:
        parents = width // 2
        g = group_for(parents, sms)
        plan.append(("level", parents, g, block_for(parents * g, sms)))
        width, left = parents, left - 1
    bands = []
    while left > 0:
        bands.append(min(left, SUBTREE_MAX_LAYERS))
        left -= bands[-1]
    for k in reversed(bands):
        plan.append(("subtree", width, k, width >> k,
                     SUBTREE_GROUP << (k - 1)))
        width >>= k
    return tuple(plan)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_CONSTANTS_SET = set()


def _mont_array(vals) -> np.ndarray:
    a = np.asarray(vals, dtype=np.uint64).reshape(-1) % np.uint64(bb.P)
    return ((a * np.uint64(bb.R)) % np.uint64(bb.P)).astype(np.uint32)


def scaled_diag() -> np.ndarray:
    """The kernels' internal-layer diagonal: lane 0 unused (0), lane i the
    Montgomery form of INTERNAL_SCALE * 2^shift_(i-1)."""
    return _mont_array([0] + [C.INTERNAL_SCALE * (1 << k) % bb.P
                              for k in C.INTERNAL_DIAG_SHIFTS])


def diag_powers():
    """The powers d_i^k (k = 0 .. 13) of each lane's diagonal d_i (lane 0
    zero) and their sums over lanes 1..15, S_j (j < 13), in Montgomery
    form: the constants of the kernels' partial rounds for groups."""
    d = [0] + [C.INTERNAL_SCALE * (1 << k) % bb.P
               for k in C.INTERNAL_DIAG_SHIFTS]
    pows = [[pow(x, k, bb.P) if i else 0 for k in range(N_PARTIAL + 1)]
            for i, x in enumerate(d)]
    sums = [sum(pow(x, j, bb.P) for x in d[1:]) % bb.P
            for j in range(N_PARTIAL)]
    return _mont_array(pows), _mont_array(sums)


def constant_tables() -> Tuple[np.ndarray, ...]:
    """The six uint32 tables ``poseidon2_bb_set_constants`` takes (the
    round code's, ``csrc/poseidon2_bb.cuh``)."""
    return (_mont_array(C.EXTERNAL_CONSTANTS),
            _mont_array(C.INTERNAL_CONSTANTS),
            _mont_array([C.INTERNAL_SCALE]), scaled_diag(), *diag_powers())


def _lib(device):
    """The built library, its constants set on card ``device`` (a device
    or its index) and its C signatures set, once."""
    from . import _build

    lib = _build.lib("poseidon2_bb")
    index = device if isinstance(device, int) else device.index
    if index not in _CONSTANTS_SET:
        p32 = ctypes.POINTER(ctypes.c_uint32)
        lib.poseidon2_bb_set_constants.argtypes = [p32] * 6
        with torch.cuda.device(index):
            err = lib.poseidon2_bb_set_constants(
                *(t.ctypes.data_as(p32) for t in constant_tables()))
        _build.check(err, "poseidon2_bb_set_constants")
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.poseidon2_bb_permute.argtypes = [vp, vp, ll, vp]
        lib.poseidon2_bb_leaf_sponge.argtypes = [vp, vp, ll] + [i32] * 4 + \
            [vp]
        lib.poseidon2_bb_leaf_sponge_noload.argtypes = \
            lib.poseidon2_bb_leaf_sponge.argtypes
        lib.poseidon2_bb_merkle_level.argtypes = [vp, vp, ll, i32, i32, vp]
        lib.poseidon2_bb_merkle_subtree.argtypes = [vp, vp, i32, i32, vp]
        assert lib.poseidon2_bb_subtree_max_layers() == SUBTREE_MAX_LAYERS
        _CONSTANTS_SET.add(index)
    return lib


@lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    run in one group of threads, its size from ``sponge_plan`` (the JAX
    package launches one permutation per absorb); the output is the
    same."""
    if inputs.ndim != 2 or inputs.shape[1] == 0 or not \
            1 <= num_outputs <= WIDTH:
        raise ValueError(f"hash_leaves needs (n, L>0) rows and 1 to "
                         f"{WIDTH} outputs, got {tuple(inputs.shape)}, "
                         f"{num_outputs}")
    if _on_cpu(inputs, "hash_leaves"):
        return hash_leaves_plain(inputs, num_outputs)
    inputs = inputs.contiguous()
    _check_cuda(inputs, "hash_leaves")
    n, length = inputs.shape
    record("p2_leaf_sponge", n, length, num_outputs)
    return _sponge(inputs, num_outputs,
                   *sponge_plan(n, _sms(inputs.get_device())))


def _sponge(inputs: torch.Tensor, num_outputs: int, group: int,
            threads: int, loads: bool = True) -> torch.Tensor:
    """The sponge launch of ``group`` threads a state and ``threads`` a
    block on the contiguous CUDA rows (n, L).  ``loads`` False launches
    the probe build that absorbs made-up values in place of the rows'
    (its output is no hash of them; it is not counted)."""
    from . import _build

    n, length = inputs.shape
    index = inputs.get_device()
    out = torch.empty((n, num_outputs), dtype=bb.DTYPE, device=inputs.device)
    lib = _lib(index)
    fn = lib.poseidon2_bb_leaf_sponge if loads else \
        lib.poseidon2_bb_leaf_sponge_noload
    err = fn(inputs.data_ptr(), out.data_ptr(), n, length, num_outputs,
             group, threads, _build.stream_ptr(index))
    _build.check(err, "poseidon2_bb_leaf_sponge")
    if loads:
        launches["p2_leaf_sponge"] += 1
    return out


def merkle_levels(d0: torch.Tensor, num_layers: int) -> List[torch.Tensor]:
    """Digest levels above d0 (n, 8), as ``merkle_levels_plain``, launched
    as ``merkle_plan`` says."""
    n = d0.shape[0]
    if d0.ndim != 2 or d0.shape[1] != NUM_HASH_OUT or \
            n & (n - 1) or n < (1 << num_layers):
        raise ValueError(f"merkle_levels needs (2^k, 8) digests with "
                         f"k >= {num_layers}, got {tuple(d0.shape)}")
    if _on_cpu(d0, "merkle_levels"):
        return merkle_levels_plain(d0, num_layers)
    if d0.dtype != bb.DTYPE:
        raise TypeError(f"merkle_levels needs int32 BabyBear tensors, got "
                        f"{d0.dtype}")
    d0 = d0.contiguous()
    record("p2_merkle_levels", n, num_layers)
    return _levels(d0, merkle_plan(n, num_layers, _sms(d0.get_device())))


@lru_cache(maxsize=256)
def _launches_of(n: int, plan: Tuple[tuple, ...]):
    """The level widths above n digests that ``plan`` writes, and its
    launches as (kind, source offset, destination offset, arguments), the
    offsets in bytes: the first source is d0, every other offset is into
    one buffer holding all levels, level after level."""
    row = NUM_HASH_OUT * 4
    steps, cur, dst = [], None, 0      # cur None: d0 itself
    widths = []
    for step in plan:
        if step[0] == "level":
            _, parents, g, threads = step
            steps.append(("level", cur, dst, (parents, g, threads)))
            widths.append(parents)
            cur, dst = dst, dst + parents * row
        else:
            _, width, k, subtrees, _ = step
            steps.append(("subtree", cur, dst, (width, k)))
            widths += [width >> (i + 1) for i in range(k)]
            dst += (width - subtrees) * row
            cur = dst - subtrees * row      # the subtrees' roots
    return widths, tuple(steps)


def _levels(d0: torch.Tensor, plan: Sequence[tuple]) -> List[torch.Tensor]:
    """The launches of ``plan`` (as ``merkle_plan`` gives) on the card, all
    levels written into one buffer, level after level."""
    from . import _build

    index = d0.get_device()
    lib = _lib(index)
    stream = _build.stream_ptr(index)
    widths, steps = _launches_of(d0.shape[0], tuple(map(tuple, plan)))
    buf = torch.empty((sum(widths), NUM_HASH_OUT), dtype=bb.DTYPE,
                      device=d0.device)
    base, src0 = buf.data_ptr(), d0.data_ptr()
    for kind, cur, dst, args in steps:
        src = src0 if cur is None else base + cur
        if kind == "level":
            err = lib.poseidon2_bb_merkle_level(src, base + dst, *args, stream)
        else:
            err = lib.poseidon2_bb_merkle_subtree(src, base + dst, *args,
                                                  stream)
        _build.check(err, "poseidon2_bb_merkle_" + kind)
    launches["p2_merkle_levels"] += len(steps)
    return list(buf.split(widths))
