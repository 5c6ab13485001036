"""Batched BabyBear NTT: the CUDA kernel ``csrc/ntt_bb.cu`` and its plain
torch version; and the cluster launch both fields' NTTs share.

Replaces the TPU kernel ``plonky2_goldibear_tpu/ops/ntt_bb.py:_fft_fused``
(with ``fft`` and, above 2^16, ``_fft_four_step``).  Values and twiddles
are u32 Montgomery forms (``field/bb.py``); the butterfly is one
Montgomery product with a canonical add and subtract, and no value leaves
[0, p).

A row of up to 2^15 elements is transformed by one launch in the shared
memory of a thread-block cluster (``csrc/ntt_cluster.cuh``, instantiated
for BabyBear by ``csrc/ntt_bb.cu`` and for Goldilocks by
``csrc/ntt_gl.cu``): ``plan`` chooses the cluster size, threads and shared
bytes from the batch, the row length, the SM count and the field's word
size, and ``fft_by_cluster`` replays that schedule's index arithmetic in
plain torch for the CPU tests.  Longer rows (to 2^26) take a coalesced
bit-reversal launch and then the passes of ``csrc/ntt.cuh``
(``fft_by_passes``).  These functions take the field module ``F`` (``bb``
by default, or ``gl``); ``ops/ntt.py:fft`` launches them for Goldilocks.

``fft(x, zero_prefix_log)`` launches the kernel for a CUDA tensor and runs
``fft_plain`` for a CPU tensor; there is no other dispatch and no size
threshold (the FRI final polynomial goes to the kernel too).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, NamedTuple

import torch

from ..field import bb, gl, host
from . import ntt, record

# the launch limits of csrc/ntt_bb.cu and csrc/ntt_gl.cu (the same for both
# fields but the pass tile)
LOG_TILE = 13           # BabyBear's multi-pass tile (Goldilocks: ntt.LOG_TILE)
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
# blocks a launch aims to give every SM, by word size: a Goldilocks
# butterfly is about three BabyBear ones, so its rows spread further
# (probes ntt_gl_clusters / ntt_bb_clusters)
FILL_BLOCKS = {4: 1, 8: 2}
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


def _lib_name(F) -> str:
    return "ntt_gl" if F is gl else "ntt_bb"


def _tile_log(F) -> int:
    return ntt.LOG_TILE if F is gl else LOG_TILE


def smem_bytes(n_log: int, c_log: int, zero_prefix_log: int = 0,
               F=bb) -> int:
    """A block's shared memory (l = n_log - c_log) in words of ``F``: its
    2^l positions, the compact buffer of its 2^(l - r) nonzero
    coefficients, the 2^l - 1 twiddles of the stages on lo (and a spare
    word), and the 2^l - 2^(l-c) of the stages on hi."""
    L = 1 << (n_log - c_log)
    return F.DTYPE.itemsize * (3 * L + (L >> zero_prefix_log) - (L >> c_log))


def threads_for(l_log: int) -> int:
    """Threads of a block holding 2^l_log positions: one per butterfly, at
    least a warp, at most MAX_THREADS."""
    return min(MAX_THREADS, max(32, (1 << l_log) >> 1))


def blocks_per_sm(n_log: int, c_log: int, zero_prefix_log: int = 0,
                  F=bb) -> int:
    smem = smem_bytes(n_log, c_log, zero_prefix_log, F)
    threads = threads_for(n_log - c_log)
    return min(SM_SMEM // (smem + 1024), SM_THREADS // threads,
               65536 // (REGS * threads), 32)


def cluster_logs(n_log: int, zero_prefix_log: int = 0, F=bb) -> List[int]:
    """The cluster sizes (log2) a row of 2^n_log can take: one block, or
    blocks of at least 2^MIN_BLOCK_LOG positions, more than 2^r of them,
    whose lo ranges hold 4 or more and that a thread's MAX_XCHG 16-byte
    registers exchange; all within a block's shared memory."""
    r = zero_prefix_log
    word = F.DTYPE.itemsize
    return [c for c in range(MAX_CLUSTER_LOG + 1)
            if (c == 0 or (n_log - c >= MIN_BLOCK_LOG and n_log - c > r
                           and n_log - 2 * c >= 2
                           and word << (n_log - c) <= 16 * MAX_XCHG
                           * threads_for(n_log - c)))
            and smem_bytes(n_log, c, r, F) <= MAX_SMEM]


def cluster_plan(batch: int, n_log: int, c_log: int, sms: int,
                 zero_prefix_log: int = 0, F=bb) -> Plan:
    """The launch of a given cluster size: as many clusters as fit on the
    card at once (each then walks the rows), at most one per row."""
    resident = max(1, blocks_per_sm(n_log, c_log, zero_prefix_log, F) * sms
                   >> c_log)
    return Plan("cluster", c_log, threads_for(n_log - c_log),
                smem_bytes(n_log, c_log, zero_prefix_log, F),
                min(batch, resident))


@lru_cache(maxsize=256)
def plan(batch: int, n_log: int, sms: int, zero_prefix_log: int = 0,
         F=bb) -> Plan:
    """The launch of ``fft`` for ``batch`` rows of 2^n_log of field ``F``:
    the smallest cluster that gives every SM FILL_BLOCKS blocks and
    FILL_THREADS resident threads, else (a batch of a few rows) the
    largest cluster the row allows."""
    if n_log > CLUSTER_MAX_LOG:
        return Plan("passes", 0, 0, 0, 0)
    r = zero_prefix_log
    logs = cluster_logs(n_log, r, F)
    fill = FILL_BLOCKS[F.DTYPE.itemsize] * sms
    for c in logs:
        if batch << c >= fill and blocks_per_sm(n_log, c, r, F) * \
                threads_for(n_log - c) >= FILL_THREADS:
            return cluster_plan(batch, n_log, c, sms, r, F)
    return cluster_plan(batch, n_log, logs[-1], sms, r, F)


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


def _swz(p: torch.Tensor, m: int, F=bb) -> torch.Tensor:
    """The compact buffer's address of position p < 2^m (the kernel's
    ``swz``: the top bits XORed into the low 5 for u32 words, 4 for
    u64)."""
    sb = 5 if F.DTYPE.itemsize == 4 else 4
    return p ^ (p >> max(m - sb, sb))


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
                   c_log: int = 0, F=bb) -> torch.Tensor:
    """The cluster kernel's schedule in plain torch, all blocks of a row at
    once: the strided load into each block's swizzled compact buffer, the
    stages on lo in passes of up to MAX_R (the first from the compact
    buffer), the exchange, the stages on hi with each block's twiddles, the
    store in runs of L / C.  Any c_log with
    n_log - c_log > r and n_log - 2 c_log >= 2 (or c_log = 0); ``F`` is
    the field module of x (``bb`` or ``gl``)."""
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
    compact[:, ranks[:, None], _swz(_rev(j, m_log), m_log, F)[None, :]] = \
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
            first = compact[..., _swz(cpos, m_log, F)]
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
# kernel wrapper (both fields' cluster and pass launches)
# --------------------------------------------------------------------------


class _Fns(NamedTuple):
    """The C entry points of one NTT library."""
    cluster: object
    bitrev: object
    active_clusters: object


@lru_cache(maxsize=None)
def _lib(name: str = "ntt_bb") -> _Fns:
    """The entry points of the built library ``csrc/<name>.cu``
    (``ntt_bb`` or ``ntt_gl``), their C signatures set (once)."""
    from . import _build

    lib = _build.lib(name)
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fns = _Fns(getattr(lib, name + "_cluster"), getattr(lib, name + "_bitrev"),
               getattr(lib, name + "_active_clusters"))
    for fn in fns:
        fn.restype = i32
    fns.cluster.argtypes = [vp, vp, vp, ll] + [i32] * 6 + [vp]
    fns.bitrev.argtypes = [vp, vp, ll, i32, i32, vp]
    fns.active_clusters.argtypes = [i32] * 3
    assert getattr(lib, name + "_cluster_max_log")() == CLUSTER_MAX_LOG
    assert getattr(lib, name + "_max_cluster_log")() == MAX_CLUSTER_LOG
    return fns


@lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@lru_cache(maxsize=64)
def _twiddles(n_log: int, index: int, F=bb) -> torch.Tensor:
    """The twiddle table of ``F`` on card ``index``, built once."""
    return ntt.twiddles(n_log, f"cuda:{index}", F)


def active_clusters(p: Plan, F=bb) -> int:
    """Clusters of plan ``p``'s shape the card holds at once (the CUDA
    occupancy query); a launch takes at most this many."""
    return _lib(_lib_name(F)).active_clusters(p.c_log, p.threads, p.smem)


def _launch(x: torch.Tensor, r: int, p: Plan, F=bb) -> torch.Tensor:
    """The launches of plan ``p`` on the contiguous CUDA tensor x (..., n)
    of field ``F``; returns the output and the number of launches."""
    from . import _build

    n = x.shape[-1]
    n_log = n.bit_length() - 1
    batch = x.numel() // n
    out = torch.empty_like(x)
    index = x.get_device()
    tw = _twiddles(n_log, index, F)
    stream = _build.stream_ptr(index)
    name = _lib_name(F)
    lib = _lib(name)
    if p.route == "cluster":
        err = lib.cluster(x.data_ptr(), out.data_ptr(), tw.data_ptr(), batch,
                          n_log, p.c_log, r, p.threads, p.clusters, p.smem,
                          stream)
        _build.check(err, name + "_cluster")
        return out, 1
    if n_log - r < 10:
        raise ValueError(f"fft: rows of 2^{n_log} need at least 2^10 "
                         f"nonzero coefficients, got zero_prefix_log {r}")
    err = lib.bitrev(x.data_ptr(), out.data_ptr(), batch, n_log, r, stream)
    _build.check(err, name + "_bitrev")
    passes = ntt.pass_plan(n_log, _tile_log(F))
    fn = ntt.pass_fn(name)
    for s0, s1 in passes:
        err = fn(out.data_ptr(), out.data_ptr(), tw.data_ptr(), batch, n_log,
                 s0, s1, max(s0, r), stream)
        _build.check(err, name + "_pass")
    return out, 1 + len(passes)


def launch(x: torch.Tensor, zero_prefix_log: int, F=bb) -> torch.Tensor:
    """The kernel launches of ``fft`` for the CUDA tensor x (..., n) of
    field ``F``, as ``plan`` says; returns the output and the number of
    launches."""
    n = x.shape[-1]
    batch = x.numel() // n
    p = plan(batch, n.bit_length() - 1, _sms(x.get_device()),
             zero_prefix_log, F)
    return _launch(x.contiguous(), zero_prefix_log, p, F)


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
        record("ntt_bb", x.numel() // n, n, zero_prefix_log)
        out, k = launch(x, zero_prefix_log)
        launches += k
        return out
    return fft_plain(x, zero_prefix_log)
