"""The device transcript's kernels (``csrc/transcript.cu``) and their plain
torch versions: one Fiat-Shamir step (``transcript_flush``) and the FRI
proof-of-work grind (``pow_grind``), for Poseidon-GL (``int64`` states of
12) and Poseidon2-BB (``int32`` Montgomery states of 16); the dtype of the
state says which.

They replace no Pallas kernel: the JAX package runs the step as one jitted
XLA program (``plonky2_goldibear_tpu/hash/device_challenger.py:
_flush_program``) and the grind as one ``lax.while_loop`` program
(``fri/prover.py:_grind_async_jit``).  Here each is one launch, so the
device-transcript prover (``plonk/prover_async.py``) dispatches a whole
proof without reading anything back.  A step is a chain of dependent
permutations of one state, bound by their latency: the kernel holds the
state in a group of 12 (GL) or 16 (BB) threads.  The grind is bound by the
permutations of the candidates it tries, one thread a state; its blocks
claim chunks of candidates in ascending order and keep the least hit, so
the witness is the smallest one that passes (the sync grinder's first
hit), and an exhausted search is a flag, not a hang.  See the source.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; there is no other dispatch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import bb, gl
from ..hash import _poseidon_gl_constants as CGL
from . import poseidon2_bb as p2
from . import poseidon_gl as pgl
from . import record

RATE = 8
GRIND_BATCH_CPU = 1 << 12   # candidates a batch of the plain grind on the CPU
GRIND_BATCH_CUDA = 1 << 17  # and on the card (the sync path's batch)
GRIND_BLOCKS_PER_SM = 4     # the grind's blocks: resident ones, per SM
GRIND_CHUNK = 128           # candidates a claim: csrc/transcript.cu's block

launches = {"transcript_flush": 0, "pow_grind": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _hasher(dtype):
    """(field module, width, plain permutation, C suffix) of a state
    dtype."""
    if dtype == gl.DTYPE:
        return gl, pgl.WIDTH, pgl.permute_plain, "gl"
    if dtype == bb.DTYPE:
        return bb, p2.WIDTH, p2.permute_plain, "bb"
    raise TypeError(f"no device transcript for {dtype} states")


def flush_schedule(total: int, n_out: int, n: int) -> Tuple[int, int]:
    """(dependent permutations, outputs left) of a step that absorbs
    ``total`` elements and then squeezes n, with ``n_out`` outputs left
    before it, as the host Challenger counts them: one permutation a full
    chunk absorbed, one a squeeze that finds the output buffer empty or
    inputs pending; a last observe that fills the chunk refills the
    outputs."""
    n_full, leftover = divmod(total, RATE)
    cur = RATE if total and not leftover else (0 if total else n_out)
    perms = n_full
    for _ in range(n):
        if leftover or cur == 0:
            perms, leftover, cur = perms + 1, 0, RATE
        cur -= 1
    return perms, cur


# --------------------------------------------------------------------------
# plain torch versions
# --------------------------------------------------------------------------


def transcript_flush_plain(state: torch.Tensor, out_buf: torch.Tensor,
                           pieces: Sequence[torch.Tensor], n_out: int,
                           n: int) -> torch.Tensor:
    """One transcript step as the host Challenger runs it (reference
    iop/challenger.rs:18-160; JAX ``_flush_program``): absorb the pieces
    (overwrite state[0..RATE], permute at each full chunk; a last observe
    that fills the buffer refills the outputs), then squeeze n challenges
    from the end of the output buffer, absorbing the partial chunk first.
    ``n_out`` the outputs left before the step.  Returns new state (W) |
    output buffer (RATE) | the challenges, or the leftover inputs when n
    is 0, as one tensor."""
    F, W, permute, _ = _hasher(state.dtype)
    stream = torch.cat(list(pieces)) if len(pieces) else state[:0]
    total = stream.shape[0]
    s, o = state, out_buf
    n_full, leftover = divmod(total, RATE)

    def perm(x):
        return permute(x[None])[0]

    pos = 0
    for _ in range(n_full):
        s = perm(torch.cat([stream[pos:pos + RATE], s[RATE:]]))
        pos += RATE
    if total and leftover == 0:
        o, cur = s[:RATE], RATE
    else:
        cur = 0 if total else n_out
    outs = []
    for _ in range(n):
        if leftover or cur == 0:
            if leftover:
                s = torch.cat([stream[pos:], s[leftover:]])
                leftover = 0
            s = perm(s)
            o, cur = s[:RATE], RATE
        outs.append(o[cur - 1:cur])
        cur -= 1
    if n == 0 and leftover:
        outs.append(stream[pos:])
    return torch.cat([s, o] + outs)


def pow_grind_plain(state: torch.Tensor, leftover: Optional[torch.Tensor],
                    k: int, batch: Optional[int] = None,
                    permute=None, limit: int = 1 << 32) -> torch.Tensor:
    """The smallest w < 2^32 whose response passes, as the sync grinder
    finds it: candidates in ascending batches, the first hit of the first
    batch with one (``fri/prover.py:fri_proof_of_work``).  The state's
    first L lanes are overwritten by ``leftover`` (L elements or None) and
    w goes in lane L; the response is lane RATE - 1, and passes when its
    canonical value is below 2^k.  Returns (w, found) as two field
    elements; (0, 0) when no candidate below ``limit`` passes.
    ``permute`` the batched permutation (the plain one by default; the
    sync prover passes the hasher's, its kernel on the card)."""
    F, W, plain, _ = _hasher(state.dtype)
    permute = permute or plain
    dev = state.device
    L = 0 if leftover is None else leftover.shape[0]
    base = state if L == 0 else torch.cat([leftover, state[L:]])
    if batch is None:
        batch = GRIND_BATCH_CUDA if dev.type == "cuda" else GRIND_BATCH_CPU
    start = 0
    while start < limit:
        cands = start + torch.arange(min(batch, limit - start),
                                     dtype=torch.int64, device=dev)
        st = F.grind_set_lane(base.expand(cands.shape[0], -1), L, cands)
        ok = F.grind_response_ok(permute(st)[:, RATE - 1], k)
        hits = torch.nonzero(ok)
        if hits.numel():
            w = start + int(hits[0, 0])
            return torch.cat([F.from_ints([w], dev), F.ones((1,), dev)])
        start += batch
    return F.zeros((2,), dev)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_CONSTANTS_SET = set()
MAX_PIECES = 8          # csrc/transcript.cu's pointer table


def _lib(device):
    """The built library, its constants of both hashers set on ``device``
    and its C signatures set, once."""
    from . import _build

    lib = _build.lib("transcript")
    if device.index not in _CONSTANTS_SET:
        p64 = ctypes.POINTER(ctypes.c_uint64)
        p32 = ctypes.POINTER(ctypes.c_uint32)
        lib.transcript_set_constants_gl.argtypes = [p64]
        lib.transcript_set_constants_bb.argtypes = [p32] * 6
        rc = np.array(CGL.ALL_ROUND_CONSTANTS, dtype=np.uint64)
        tables = p2.constant_tables()
        with torch.cuda.device(device):
            err = lib.transcript_set_constants_gl(rc.ctypes.data_as(p64))
            _build.check(err, "transcript_set_constants_gl")
            err = lib.transcript_set_constants_bb(
                *(t.ctypes.data_as(p32) for t in tables))
            _build.check(err, "transcript_set_constants_bb")
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for f in ("gl", "bb"):
            getattr(lib, "transcript_flush_" + f).argtypes = [
                vp, vp, vp, vp, i32, ll, i32, i32, vp, vp]
            getattr(lib, "pow_grind_" + f).argtypes = [
                vp, vp, i32, i32, i32, vp, vp, vp]
        assert lib.transcript_max_pieces() == MAX_PIECES
        assert lib.pow_grind_threads() == GRIND_CHUNK
        _CONSTANTS_SET.add(device.index)
    return lib


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def _check(x: torch.Tensor, dtype, numel: int, what: str) -> None:
    if x.dtype != dtype or x.ndim != 1 or x.shape[0] != numel or \
            not x.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous ({numel},) {dtype} "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")


def transcript_flush(state: torch.Tensor, out_buf: torch.Tensor,
                     pieces: Sequence[torch.Tensor], n_out: int,
                     n: int) -> torch.Tensor:
    """One transcript step, as ``transcript_flush_plain``: one launch on
    the card (the pieces read through a pointer table; more than
    MAX_PIECES are joined first)."""
    F, W, _, suffix = _hasher(state.dtype)
    if _on_cpu(state, "transcript_flush"):
        return transcript_flush_plain(state, out_buf, pieces, n_out, n)
    from . import _build

    _check(state, F.DTYPE, W, "transcript_flush state")
    _check(out_buf, F.DTYPE, RATE, "transcript_flush output buffer")
    pieces = [p for p in pieces if p.shape[0]]
    if len(pieces) > MAX_PIECES:
        pieces = [torch.cat(pieces)]
    ends, total = [], 0
    for p in pieces:
        _check(p, F.DTYPE, p.shape[0], "transcript_flush piece")
        if p.device != state.device:
            raise ValueError("transcript_flush: a piece on another device")
        total += p.shape[0]
        ends.append(total)
    # after the state and the output buffer: the n challenges, or the
    # leftover inputs when n is 0
    dst = torch.empty(W + RATE + (n or total % RATE), dtype=F.DTYPE,
                      device=state.device)
    ptrs = (ctypes.c_void_p * MAX_PIECES)(*[p.data_ptr() for p in pieces])
    ends_c = (ctypes.c_longlong * MAX_PIECES)(*ends)
    record("transcript_flush", W, total, n_out, n)
    err = getattr(_lib(state.device), "transcript_flush_" + suffix)(
        state.data_ptr(), out_buf.data_ptr(), ptrs, ends_c, len(pieces),
        total, n_out, n, dst.data_ptr(), _build.stream_ptr(state.device))
    _build.check(err, "transcript_flush_" + suffix)
    launches["transcript_flush"] += 1
    return dst


def pow_grind(state: torch.Tensor, leftover: Optional[torch.Tensor],
              k: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(w, found) as ``pow_grind_plain``, and on the card the search's
    counters (int64: chunks claimed, ~w, blocks done, chunks tested, a
    chunk GRIND_CHUNK candidates); None for them on the CPU.
    One launch on the card, which reads nothing back."""
    F, W, _, suffix = _hasher(state.dtype)
    if _on_cpu(state, "pow_grind"):
        return pow_grind_plain(state, leftover, k), None
    from . import _build

    _check(state, F.DTYPE, W, "pow_grind state")
    L = 0 if leftover is None else leftover.shape[0]
    if L:
        _check(leftover, F.DTYPE, L, "pow_grind leftover")
    lib = _lib(state.device)
    out = torch.empty(2, dtype=F.DTYPE, device=state.device)
    scratch = torch.empty(4, dtype=torch.int64, device=state.device)
    blocks = GRIND_BLOCKS_PER_SM * pgl._sms(state.device)
    record("pow_grind", W, L, k)
    err = getattr(lib, "pow_grind_" + suffix)(
        state.data_ptr(), leftover.data_ptr() if L else None, L, k, blocks,
        scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(state.device))
    _build.check(err, "pow_grind_" + suffix)
    launches["pow_grind"] += 1
    return out, scratch
