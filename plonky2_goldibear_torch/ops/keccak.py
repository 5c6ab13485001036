"""Keccak kernels (``csrc/keccak.cu``) and their plain torch versions (on
``hash/keccak_device.py``): the digest of each row of bytes, the Merkle
levels over 25-byte digests, and the hash-onion permutation of Goldilocks
states.

The JAX package has no Pallas kernel for Keccak: its device program is
jnp (``plonky2_goldibear_tpu/hash/keccak_device.py:keccak_f``).  On the
H100 a launch that fills the card is bound by its 32-bit integer
instructions (at least 4,320 a Keccak-f, against at most 161 bytes a
block), a narrower one by one Keccak-f's latency.  A state is held by a
group of 1 or 25 threads, chosen per launch by the pure plans below
(``group_for``, ``launch_plan``, ``merkle_plan``): one thread where the
launch fills the card, more for the narrow Merkle levels and FRI rows; a
tree's narrow top levels are one subtree launch, and its launches one
host call (see the note in the source).  Layouts follow the JAX package's public functions: rows (n, L)
uint8, digests (n, 25) uint8 in natural node order, states (..., 12)
int64 Goldilocks bit patterns.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; there is no other dispatch.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Sequence, Tuple

import torch

from ..hash import keccak_device as kd
from . import record

DIGEST = 25            # bytes of a digest (the reference's HASH_SIZE)
WIDTH = kd.WIDTH       # 12 Goldilocks elements a hash-onion state

# launches of each kernel: rows, a Merkle level, a Merkle subtree (the
# narrow top levels), the hash-onion
launches = {"keccak_rows": 0, "keccak_merkle_levels": 0,
            "keccak_merkle_subtree": 0, "keccak_permute": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# --------------------------------------------------------------------------
# plain torch versions
# --------------------------------------------------------------------------


def hash_rows_plain(rows: torch.Tensor,
                    out_bytes: int = DIGEST) -> torch.Tensor:
    """The first ``out_bytes`` bytes of the Keccak-256 of each row
    (n, L) uint8."""
    return kd.keccak256_bytes(rows)[:, :out_bytes].contiguous()


def merkle_levels_plain(d0: torch.Tensor, num_layers: int
                        ) -> List[torch.Tensor]:
    """Digests (n, 25) -> [level_1, ..., level_num_layers], level k of
    n >> k digests in natural node order (parent i of children 2i, 2i+1)."""
    levels = []
    cur = d0
    for _ in range(num_layers):
        cur = hash_rows_plain(cur.reshape(-1, 2 * DIGEST))
        levels.append(cur)
    return levels


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """The hash-onion of states (..., 12)."""
    return kd.permute(state)


# --------------------------------------------------------------------------
# launch geometry (pure functions of the shapes and the SM count)
# --------------------------------------------------------------------------

GROUPS = (1, 25)            # threads a state the kernels are built for
PER_WARP = {1: 32, 25: 1}   # groups a warp (G = 25: 7 threads spare)
# states an SM at or above which a launch takes one thread a state, else
# 25: the keccak_groups sweep (probes.py) on the H100's 132 SMs, where one
# thread is faster down to 2^11 states and 25 threads from 2^10 down
FILL_PER_SM = 15
MAX_THREADS = 256           # the source's largest rows or level block
TAIL_LAYERS = 4             # the source's deepest subtree (16 digests)


def threads_for(states: int, group: int) -> int:
    """Threads (whole warps) that ``states`` states take in groups of
    ``group``."""
    return -(-states // PER_WARP[group]) * 32


def group_for(states: int, sms: int) -> int:
    """Threads a state for a launch of ``states`` Keccak-f chains: one
    where the launch fills the card, 25 where it leaves the SMs' issue
    slots idle."""
    return GROUPS[0] if states >= FILL_PER_SM * sms else GROUPS[-1]


def block_for(threads: int, sms: int) -> int:
    """Threads a block: 128, fewer (down to one warp) where that spreads
    the launch over more SMs, but never so few that some SMs get two
    blocks where one each would do (a level of 2^14 parents: 128 blocks
    of 128, not 171 of 96)."""
    return min(128, max(32, -(-threads // (32 * sms)) * 32))


@lru_cache(maxsize=256)
def launch_plan(states: int, sms: int) -> Tuple[int, int]:
    """(threads a state, threads a block) of a launch of ``states``
    Keccak-f chains: the rows of ``hash_rows`` (each block of a row is one
    Keccak-f after the last, so a row's length adds latency, not
    parallelism) or the parents of one Merkle level."""
    g = group_for(states, sms)
    return g, block_for(threads_for(states, g), sms)


@lru_cache(maxsize=256)
def merkle_plan(n: int, num_layers: int, sms: int) -> Tuple[tuple, ...]:
    """The launches of ``merkle_levels`` for n digests, n / 2 parents
    first: ("level", parents, threads a state, threads a block) a level,
    then the top levels that take 25 threads a state, TAIL_LAYERS at most,
    as one ("subtree", width, layers) launch of a block a subtree (it
    saves their launches' host time, which is more than a narrow level's
    time on the card)."""
    cap = n >> num_layers
    k = min(num_layers, TAIL_LAYERS)
    while k and group_for(cap << (k - 1), sms) != GROUPS[-1]:
        k -= 1
    plan = tuple(("level", n >> j, *launch_plan(n >> j, sms))
                 for j in range(1, num_layers - k + 1))
    return plan + ((("subtree", cap << k, k),) if k else ())


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_LIB = []          # the bound library, once loaded


def _lib():
    """The built library with its C signatures set (kept after the first
    call: a small launch is mostly the wrapper's host time)."""
    if _LIB:
        return _LIB[0]
    from . import _build

    lib = _build.lib("keccak")
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.keccak_rows.argtypes = [vp, vp, ll, i32, i32, i32, i32, i32, vp]
    lib.keccak_merkle_run.argtypes = [vp, vp, vp, i32, vp]
    lib.keccak_permute.argtypes = [vp, vp, ll, vp]
    assert lib.keccak_max_threads() == MAX_THREADS
    assert lib.keccak_subtree_max_layers() == TAIL_LAYERS
    _LIB.append(lib)
    return lib


@lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def _check(x: torch.Tensor, dtype, what: str) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{what} needs {dtype} tensors, got {x.dtype}")


def hash_rows(rows: torch.Tensor, out_bytes: int = DIGEST) -> torch.Tensor:
    """The digest of each row (n, L) uint8 -> (n, out_bytes) uint8, as
    ``hash_rows_plain``: 1 <= out_bytes <= 32.  The launch's geometry is
    ``launch_plan``'s."""
    if rows.ndim != 2 or not 1 <= out_bytes <= 32:
        raise ValueError(f"hash_rows needs (n, L) rows and 1 to 32 output "
                         f"bytes, got {tuple(rows.shape)}, {out_bytes}")
    _check(rows, torch.uint8, "hash_rows")
    if _on_cpu(rows, "hash_rows"):
        return hash_rows_plain(rows, out_bytes)
    rows = rows.contiguous()
    n, length = rows.shape
    record("keccak_rows", n, length)
    return _rows(rows, out_bytes,
                 *launch_plan(n, _sms(rows.get_device())))


def _rows(rows: torch.Tensor, out_bytes: int, group: int,
          threads: int) -> torch.Tensor:
    """The rows launch of ``group`` threads a row and ``threads`` a block
    on the contiguous CUDA rows (n, L)."""
    from . import _build

    n, length = rows.shape
    out = torch.empty((n, out_bytes), dtype=torch.uint8, device=rows.device)
    aligned = length % 8 == 0 and rows.data_ptr() % 8 == 0
    err = _lib().keccak_rows(rows.data_ptr(), out.data_ptr(), n, length,
                             out_bytes, int(aligned), group, threads,
                             _build.stream_ptr(rows.get_device()))
    _build.check(err, "keccak_rows")
    launches["keccak_rows"] += 1
    return out


def merkle_levels(d0: torch.Tensor, num_layers: int) -> List[torch.Tensor]:
    """Digest levels above d0 (n, 25), as ``merkle_levels_plain``, launched
    as ``merkle_plan`` says."""
    n = d0.shape[0]
    if d0.ndim != 2 or d0.shape[1] != DIGEST or n & (n - 1) or \
            n < (1 << num_layers):
        raise ValueError(f"merkle_levels needs (2^k, {DIGEST}) digests with "
                         f"k >= {num_layers}, got {tuple(d0.shape)}")
    _check(d0, torch.uint8, "merkle_levels")
    if _on_cpu(d0, "merkle_levels"):
        return merkle_levels_plain(d0, num_layers)
    if num_layers == 0:
        return []
    d0 = d0.contiguous()
    record("keccak_merkle_levels", n, num_layers)
    return _levels(d0, merkle_plan(n, num_layers, _sms(d0.get_device())))


@lru_cache(maxsize=256)
def _launches_of(n: int, plan: Tuple[tuple, ...]):
    """The level widths above n digests that ``plan`` writes, its launches
    as the C array ``keccak_merkle_run`` reads (6 words a launch: kind,
    source and destination byte offsets into one buffer holding all
    levels, level after level, the first source -1 for d0 itself, then
    the launch's arguments), and its launches of each kind.  A plan whose
    levels do not halve from n, one after the other, is refused."""
    steps, widths = [], []
    cur, dst, width = -1, 0, n
    counts = {"level": 0, "subtree": 0}
    for step in plan:
        if step[0] == "level" and len(step) == 4:
            _, parents, g, threads = step
            if parents != width // 2 or width % 2 or g not in GROUPS or \
                    threads % 32 or not 32 <= threads <= MAX_THREADS:
                raise ValueError(f"bad level launch {step} above {width} "
                                 "digests")
            steps += [0, cur, dst, parents, g, threads]
            level = [parents]
        elif step[0] == "subtree" and len(step) == 3:
            _, sub_width, k = step
            if sub_width != width or not 1 <= k <= TAIL_LAYERS or \
                    width % (1 << k):
                raise ValueError(f"bad subtree launch {step} above {width} "
                                 "digests")
            steps += [1, cur, dst, width, k, 0]
            level = [width >> (i + 1) for i in range(k)]
        else:
            raise ValueError(f"unknown launch {step}")
        counts[step[0]] += 1
        widths += level
        cur = dst + (sum(level) - level[-1]) * DIGEST
        dst += sum(level) * DIGEST
        width = level[-1]
    return (widths, (ctypes.c_longlong * len(steps))(*steps),
            counts["level"], counts["subtree"])


def _levels(d0: torch.Tensor, plan: Sequence[tuple]) -> List[torch.Tensor]:
    """The launches of ``plan`` (as ``merkle_plan`` gives) on the card, all
    levels written into one buffer, level after level, by one call."""
    from . import _build

    widths, steps, n_level, n_subtree = _launches_of(
        d0.shape[0], tuple(map(tuple, plan)))
    buf = torch.empty((sum(widths), DIGEST), dtype=torch.uint8,
                      device=d0.device)
    err = _lib().keccak_merkle_run(d0.data_ptr(), buf.data_ptr(), steps,
                                   n_level + n_subtree,
                                   _build.stream_ptr(d0.get_device()))
    _build.check(err, "keccak_merkle_run")
    launches["keccak_merkle_levels"] += n_level
    launches["keccak_merkle_subtree"] += n_subtree
    return list(buf.split(widths))


def permute(state: torch.Tensor) -> torch.Tensor:
    """The hash-onion of states (..., 12) of canonical Goldilocks
    elements (int64 bit patterns), as ``permute_plain``."""
    if state.shape[-1] != WIDTH:
        raise ValueError(f"permute needs (..., 12) states, got "
                         f"{tuple(state.shape)}")
    _check(state, torch.int64, "permute")
    if _on_cpu(state, "permute"):
        return permute_plain(state)
    from . import _build

    state = state.contiguous()
    out = torch.empty_like(state)
    n = state.numel() // WIDTH
    record("keccak_permute", n)
    err = _lib().keccak_permute(state.data_ptr(), out.data_ptr(), n,
                                _build.stream_ptr(state.get_device()))
    _build.check(err, "keccak_permute")
    launches["keccak_permute"] += 1
    return out
