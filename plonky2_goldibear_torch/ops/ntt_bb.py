"""Batched BabyBear NTT: the CUDA kernel ``csrc/ntt_bb.cu`` and its plain
torch version.

Replaces the TPU kernel ``plonky2_goldibear_tpu/ops/ntt_bb.py:_fft_fused``
(with ``fft`` and, above 2^16, ``_fft_four_step``).  Values and twiddles
are u32 Montgomery forms (``field/bb.py``); the butterfly is one
Montgomery product with a canonical add and subtract, and no value leaves
[0, p).

A row of up to 2^15 elements is transformed by one launch in the shared
memory of a thread-block cluster (see the note in the source): ``plan``
chooses the cluster size, threads and shared bytes from the batch, the
row length and the SM count, and ``fft_by_cluster`` replays that
schedule's index arithmetic in plain torch for the CPU tests.  Longer
rows (to 2^26) take a coalesced bit-reversal launch and then the passes
of ``csrc/ntt.cuh`` (``fft_by_passes``).

``fft(x, zero_prefix_log)`` launches the kernel for a CUDA tensor and runs
``fft_plain`` for a CPU tensor; there is no other dispatch and no size
threshold (the FRI final polynomial goes to the kernel too).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, NamedTuple

import torch

from ..field import bb, host
from . import ntt, record

LOG_TILE = 13           # the multi-pass tile; must match csrc/ntt_bb.cu
CLUSTER_MAX_LOG = 15    # rows up to 2^15 take one cluster launch
MAX_CLUSTER_LOG = 4     # at most 16 blocks a cluster
MIN_BLOCK_LOG = 9       # a block of a cluster of 2 or more holds >= 2^9
MAX_THREADS = 512
MAX_XCHG = 4            # 16-byte words a thread sends in the exchange
MAX_R = 3               # stages a pass takes (radix 2^MAX_R)
REGS = 64               # registers a thread may take (2 blocks of 512 an SM)
MAX_SMEM = 232448       # bytes of shared memory one block can use
SM_SMEM = 233472        # per SM, of which 1 KB is reserved per block
SM_THREADS = 2048
FILL_THREADS = 1024     # resident threads per SM a launch aims for
launches = 0            # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    launches = 0


class Plan(NamedTuple):
    """One NTT call: ``route`` "cluster" (one launch of ``clusters``
    clusters of 2^c_log blocks, ``threads`` threads and ``smem`` bytes of
    shared memory a block) or "passes" (a bit-reversal launch, then the
    ``ntt.pass_plan`` passes; the other fields 0)."""
    route: str
    c_log: int
    threads: int
    smem: int
    clusters: int


def smem_bytes(n_log: int, c_log: int, zero_prefix_log: int = 0) -> int:
    """A block's shared memory (l = n_log - c_log): its 2^l positions, the
    compact buffer of its 2^(l - r) nonzero coefficients, the 2^l - 1
    twiddles of the stages on lo (and a spare word), and the 2^l - 2^(l-c)
    of the stages on hi."""
    L = 1 << (n_log - c_log)
    return 4 * (3 * L + (L >> zero_prefix_log) - (L >> c_log))


def threads_for(l_log: int) -> int:
    """Threads of a block holding 2^l_log positions: one per butterfly, at
    least a warp, at most MAX_THREADS."""
    return min(MAX_THREADS, max(32, (1 << l_log) >> 1))


def blocks_per_sm(n_log: int, c_log: int, zero_prefix_log: int = 0) -> int:
    smem = smem_bytes(n_log, c_log, zero_prefix_log)
    threads = threads_for(n_log - c_log)
    return min(SM_SMEM // (smem + 1024), SM_THREADS // threads,
               65536 // (REGS * threads), 32)


def cluster_logs(n_log: int, zero_prefix_log: int = 0) -> List[int]:
    """The cluster sizes (log2) a row of 2^n_log can take: one block, or
    blocks of at least 2^MIN_BLOCK_LOG positions, more than 2^r of them,
    whose lo ranges hold 4 or more and that a thread's MAX_XCHG registers
    exchange; all within a block's shared memory."""
    r = zero_prefix_log
    return [c for c in range(MAX_CLUSTER_LOG + 1)
            if (c == 0 or (n_log - c >= MIN_BLOCK_LOG and n_log - c > r
                           and n_log - 2 * c >= 2
                           and 1 << (n_log - c) <= 4 * MAX_XCHG
                           * threads_for(n_log - c)))
            and smem_bytes(n_log, c, r) <= MAX_SMEM]


def cluster_plan(batch: int, n_log: int, c_log: int, sms: int,
                 zero_prefix_log: int = 0) -> Plan:
    """The launch of a given cluster size: as many clusters as fit on the
    card at once (each then walks the rows), at most one per row."""
    resident = max(1, blocks_per_sm(n_log, c_log, zero_prefix_log) * sms
                   >> c_log)
    return Plan("cluster", c_log, threads_for(n_log - c_log),
                smem_bytes(n_log, c_log, zero_prefix_log),
                min(batch, resident))


@lru_cache(maxsize=256)
def plan(batch: int, n_log: int, sms: int, zero_prefix_log: int = 0) -> Plan:
    """The launch of ``fft`` for ``batch`` rows of 2^n_log: the smallest
    cluster that gives every SM a block and FILL_THREADS resident threads,
    else (a batch of a few rows) the largest cluster the row allows."""
    if n_log > CLUSTER_MAX_LOG:
        return Plan("passes", 0, 0, 0, 0)
    r = zero_prefix_log
    logs = cluster_logs(n_log, r)
    for c in logs:
        if batch << c >= sms and blocks_per_sm(n_log, c, r) * \
                threads_for(n_log - c) >= FILL_THREADS:
            return cluster_plan(batch, n_log, c, sms, r)
    return cluster_plan(batch, n_log, logs[-1], sms, r)


# --------------------------------------------------------------------------
# plain torch versions
# --------------------------------------------------------------------------


def fft_plain(x: torch.Tensor, zero_prefix_log: int = 0) -> torch.Tensor:
    """Radix-2 DIT NTT over the last axis, one torch pass per stage."""
    return ntt.fft_plain(x, zero_prefix_log, bb)


def fft_by_passes(x: torch.Tensor, zero_prefix_log: int = 0,
                  tile_log: int = LOG_TILE) -> torch.Tensor:
    """The multi-pass schedule (rows above 2^15) in plain torch."""
    return ntt.fft_by_passes(x, zero_prefix_log, tile_log, bb)


def _rev(i: torch.Tensor, bits: int) -> torch.Tensor:
    r = torch.zeros_like(i)
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i = i >> 1
    return r


def _swz(p: torch.Tensor, m: int) -> torch.Tensor:
    """The compact buffer's address of position p < 2^m (the kernel's
    ``swz``)."""
    return p ^ (p >> max(m - 5, 5))


def _radix_pass(F, data, s: int, rows, x=None) -> None:
    """Stages s .. s + R - 1 (R = len(rows)) in one pass, as the kernel's
    radix_pass: unit v takes positions e + i 2^s, i < 2^R, e = (v >> s) <<
    (s + R) | (v mod 2^s); stage s + j pairs i and i + 2^j with twiddle
    rows[j][k + (i mod 2^j) 2^s] (a row per block where rows[j] is
    (C, ...)).  Its inputs are ``x`` (..., units, 2^R) when given (the
    compact buffer), else those positions of data (batch, C, L)."""
    R, h = len(rows), 1 << s
    M = 1 << R
    v = torch.arange(data.shape[-1] >> R, device=data.device)
    k = v & (h - 1)
    e = ((v >> s) << (s + R)) + k
    if x is None:
        x = torch.stack([data[..., e + i * h] for i in range(M)], dim=-1)
    x = list(x.unbind(-1))
    for j in range(R):
        for i in range(M):
            if i & (1 << j):
                continue
            t = F.mul(x[i + (1 << j)], rows[j][..., k + (i & ((1 << j) - 1)) * h])
            x[i], x[i + (1 << j)] = F.add(x[i], t), F.sub(x[i], t)
    for i in range(M):
        data[..., e + i * h] = x[i]


def fft_by_cluster(x: torch.Tensor, zero_prefix_log: int = 0,
                   c_log: int = 0) -> torch.Tensor:
    """The cluster kernel's schedule in plain torch, all blocks of a row at
    once: the strided load into each block's swizzled compact buffer, the
    stages on lo in passes of up to MAX_R (the first from the compact
    buffer), the exchange, the stages on hi with each block's twiddles, the
    store in runs of L / C.  Any c_log with
    n_log - c_log > r and n_log - 2 c_log >= 2 (or c_log = 0)."""
    F = bb
    n = x.shape[-1]
    n_log = host.log2_strict(n)
    r = zero_prefix_log
    assert c_log == 0 or (n_log - c_log > r and n_log - 2 * c_log >= 2)
    flat = x.reshape(-1, n)
    batch, dev = flat.shape[0], x.device
    l_log = n_log - c_log
    lc_log = l_log - c_log
    L, Lc, C = 1 << l_log, 1 << lc_log, 1 << c_log
    m_log = l_log - r
    tw = ntt.twiddles(n_log, str(dev), F)
    twl = tw[:L - 1]
    ranks = torch.arange(C, device=dev)
    # load: block b, compact position rev(j) <- x[(j << c) | rev(b)]
    j = torch.arange(1 << m_log, device=dev)
    src = (j[None, :] << c_log) | _rev(ranks, c_log)[:, None]     # (C, Mc)
    compact = F.zeros((batch, C, 1 << m_log), dev)
    compact[:, ranks[:, None], _swz(_rev(j, m_log), m_log)[None, :]] = \
        flat[:, src]
    data = F.zeros((batch, C, L), dev)
    if r == l_log:
        data[...] = compact[..., :1]
    s = r
    while s < l_log:
        R = min(MAX_R, l_log - s)
        rows = [twl[(1 << (s + j)) - 1:] for j in range(R)]
        first = None
        if s == r:          # the first pass reads the compact buffer
            v = torch.arange(L >> R, device=dev)
            cpos = (v >> r)[:, None] * (1 << R) + torch.arange(1 << R,
                                                                device=dev)
            first = compact[..., _swz(cpos, m_log)]
        _radix_pass(F, data, s, rows, first)
        s += R
    if c_log:
        # block b's (b, lo) goes to block lo >> lc_log at b Lc + lo mod Lc
        lo = torch.arange(L, device=dev)
        recv = F.zeros((batch, C, L), dev)
        recv[:, (lo >> lc_log)[None, :],
             (ranks[:, None] * Lc) + (lo & (Lc - 1))[None, :]] = data
        data = recv

        def twh(t):
            """Block b's twiddles of hi stage t: k = (hi mod 2^t) L + b Lc
            + lo' at local index (hi mod 2^t) Lc + lo'."""
            idx = torch.arange(Lc << t, device=dev)
            k = ((idx >> lc_log)[None, :] << l_log) + ranks[:, None] * Lc + \
                (idx & (Lc - 1))[None, :]
            return tw[(1 << (l_log + t)) - 1 + k]               # (C, Lc 2^t)

        t = 0
        while t < c_log:
            R = min(MAX_R, c_log - t)
            _radix_pass(F, data, lc_log + t, [twh(t + j) for j in range(R)])
            t += R
    # local index e = hi Lc + lo' is position hi L + b Lc + lo'
    e = torch.arange(L, device=dev)
    pos = ((e >> lc_log)[None, :] << l_log) + ranks[:, None] * Lc + \
        (e & (Lc - 1))[None, :]
    out = F.zeros((batch, n), dev)
    out[:, pos] = data
    return out.reshape(x.shape)


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures set (once)."""
    from . import _build

    lib = _build.lib("ntt_bb")
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ntt_bb_cluster.restype = i32
    lib.ntt_bb_cluster.argtypes = [vp, vp, vp, ll] + [i32] * 6 + [vp]
    lib.ntt_bb_bitrev.restype = i32
    lib.ntt_bb_bitrev.argtypes = [vp, vp, ll, i32, i32, vp]
    lib.ntt_bb_active_clusters.restype = i32
    lib.ntt_bb_active_clusters.argtypes = [i32] * 3
    assert lib.ntt_bb_cluster_max_log() == CLUSTER_MAX_LOG
    assert lib.ntt_bb_max_cluster_log() == MAX_CLUSTER_LOG
    return lib


@lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@lru_cache(maxsize=64)
def _twiddles(n_log: int, index: int) -> torch.Tensor:
    """The twiddle table on card ``index``, built once."""
    return ntt.twiddles(n_log, f"cuda:{index}", bb)


def active_clusters(p: Plan) -> int:
    """Clusters of plan ``p``'s shape the card holds at once (the CUDA
    occupancy query); a launch takes at most this many."""
    return _lib().ntt_bb_active_clusters(p.c_log, p.threads, p.smem)


def _launch(x: torch.Tensor, r: int, p: Plan) -> torch.Tensor:
    """The launches of plan ``p`` on the contiguous CUDA tensor x (..., n);
    returns the output and the number of launches."""
    from . import _build

    n = x.shape[-1]
    n_log = n.bit_length() - 1
    batch = x.numel() // n
    out = torch.empty_like(x)
    index = x.get_device()
    tw = _twiddles(n_log, index)
    stream = _build.stream_ptr(index)
    lib = _lib()
    if p.route == "cluster":
        err = lib.ntt_bb_cluster(x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                                 batch, n_log, p.c_log, r, p.threads,
                                 p.clusters, p.smem, stream)
        _build.check(err, "ntt_bb_cluster")
        return out, 1
    if n_log - r < 10:
        raise ValueError(f"fft: rows of 2^{n_log} need at least 2^10 "
                         f"nonzero coefficients, got zero_prefix_log {r}")
    err = lib.ntt_bb_bitrev(x.data_ptr(), out.data_ptr(), batch, n_log, r,
                            stream)
    _build.check(err, "ntt_bb_bitrev")
    passes = ntt.pass_plan(n_log, LOG_TILE)
    fn = ntt.pass_fn("ntt_bb")
    for s0, s1 in passes:
        err = fn(out.data_ptr(), out.data_ptr(), tw.data_ptr(), batch, n_log,
                 s0, s1, max(s0, r), 0, r, stream)
        _build.check(err, "ntt_bb_pass")
    return out, 1 + len(passes)


def fft(x: torch.Tensor, zero_prefix_log: int = 0) -> torch.Tensor:
    """Forward NTT over the last axis of a BabyBear tensor (..., N), natural
    order in and out; ``zero_prefix_log`` = r declares that only the first
    N / 2^r coefficients may be nonzero."""
    global launches
    if ntt.check_input(x, bb):
        return x.clone()
    n = x.shape[-1]
    n_log = n.bit_length() - 1
    if not 0 <= zero_prefix_log <= n_log:
        raise ValueError(f"fft: zero_prefix_log {zero_prefix_log} outside "
                         f"[0, {n_log}]")
    if x.is_cuda:
        batch = x.numel() // n
        record("ntt_bb", batch, n, zero_prefix_log)
        p = plan(batch, n_log, _sms(x.get_device()), zero_prefix_log)
        out, k = _launch(x.contiguous(), zero_prefix_log, p)
        launches += k
        return out
    return fft_plain(x, zero_prefix_log)
