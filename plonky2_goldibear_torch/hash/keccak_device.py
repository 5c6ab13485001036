"""Batched Keccak-f[1600] and Keccak-256 in plain torch: the port of the
JAX package's ``hash/keccak_device.py`` (a jnp program, no Pallas kernel).

The plain versions of ``ops/keccak.py``'s kernels: the CPU path and the
yardstick the kernels are held to on the card.  A lane is an ``int64``
tensor holding the u64 bit pattern; torch's ``>>`` on int64 is
arithmetic, so every right shift is masked to make it logical, and ``<<``
wraps mod 2^64.  A state is (..., 25) lanes, lane i = x + 5 y; messages
are (..., L) ``uint8`` tensors with L the same for the whole batch.
Keccak-256 pads with 0x01 ... 0x80 (the original Keccak padding of the
keccak-hash crate the reference uses, plonky2/src/hash/keccak.rs:104-126),
rate 136 bytes.

``permute`` is the reference's hash-onion over 12 Goldilocks elements
with rejection sampling into the field (keccak.rs:63-98): the 96 state
bytes are hashed, then each 32-byte hash again, and every 8-byte word
below p is taken until 12 are.
"""

from __future__ import annotations

from typing import List

import torch

from ..field import gl
from ..utils.keccak import _RC, _ROT

RATE_BYTES = 136                 # Keccak-256: a 1088-bit rate
RATE_LANES = RATE_BYTES // 8     # 17
WIDTH = 12                       # the hash-onion's Goldilocks state
_PAD_LAST = -(1 << 63)           # 0x80 in the rate's last byte
_MIN = -(1 << 63)
_P_FLIP = gl.P_SIGNED ^ _MIN     # p with the sign bit flipped


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


_RC_SIGNED = [_signed(rc) for rc in _RC]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate u64 lanes left by a constant r (a logical right shift: the
    arithmetic one masked)."""
    r %= 64
    if r == 0:
        return x
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on (..., 25) int64 lanes."""
    a: List[torch.Tensor] = list(state.unbind(-1))
    for rc in _RC_SIGNED:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho and pi: B[y + 5 ((2x + 3y) % 5)] = rotl(A[x + 5y], rot[x][y])
        b: List[torch.Tensor] = [a[0]] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y],
                                                         _ROT[x][y])
        # chi, then iota
        a = [b[i] ^ (~b[(i + 1) % 5 + i // 5 * 5] & b[(i + 2) % 5 + i // 5 * 5])
             for i in range(25)]
        a[0] = a[0] ^ rc
    return torch.stack(a, dim=-1)


def _padded_lanes(msg: torch.Tensor) -> torch.Tensor:
    """(..., L) uint8 -> (..., blocks * 17) int64 lanes of the padded
    message."""
    length = msg.shape[-1]
    blocks = (length + 1 + RATE_BYTES - 1) // RATE_BYTES
    pad = torch.zeros(msg.shape[:-1] + (blocks * RATE_BYTES - length,),
                      dtype=torch.uint8, device=msg.device)
    pad[..., 0] = 0x01
    pad[..., -1] |= 0x80
    full = torch.cat([msg, pad], dim=-1).contiguous()
    return full.view(torch.int64)


def keccak256_bytes(msg: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of each row: (..., L) uint8 -> (..., 32) uint8."""
    if msg.dtype != torch.uint8:
        raise TypeError(f"keccak256_bytes needs uint8 messages, got "
                        f"{msg.dtype}")
    lanes = _padded_lanes(msg)
    state = torch.zeros(msg.shape[:-1] + (25,), dtype=torch.int64,
                        device=msg.device)
    for blk in range(lanes.shape[-1] // RATE_LANES):
        block = lanes[..., blk * RATE_LANES:(blk + 1) * RATE_LANES]
        state = keccak_f(torch.cat(
            [state[..., :RATE_LANES] ^ block, state[..., RATE_LANES:]],
            dim=-1))
    return state[..., :4].contiguous().view(torch.uint8)


def gl_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """Canonical Goldilocks elements (..., n) -> their little-endian bytes
    (..., 8 n) uint8."""
    return x.contiguous().view(torch.uint8)


def _onion_input(words: torch.Tensor) -> torch.Tensor:
    """One padded block holding k lanes (k < 17) as a state (n, 25)."""
    n, k = words.shape
    state = torch.zeros((n, 25), dtype=torch.int64, device=words.device)
    state[:, :k] = words
    state[:, k] = 1
    state[:, RATE_LANES - 1] |= _PAD_LAST
    return state


def permute(state: torch.Tensor) -> torch.Tensor:
    """The hash-onion pseudo-permutation of states (..., 12) of canonical
    Goldilocks elements: the first hash absorbs the 12 lanes, each later
    one the previous hash's 4; a row rehashes until it has 12 words below
    p (3 hashes, unless a word is rejected)."""
    shape = state.shape
    flat = state.reshape(-1, WIDTH)
    n = flat.shape[0]
    out = torch.zeros_like(flat)
    count = torch.zeros(n, dtype=torch.int64, device=flat.device)
    rows = torch.arange(n, device=flat.device)
    h = keccak_f(_onion_input(flat))[:, :4]
    while True:
        for i in range(4):
            take = ((h[:, i] ^ _MIN) < _P_FLIP) & (count < WIDTH)
            out[rows[take], count[take]] = h[take, i]
            count = count + take
        left = count < WIDTH
        if not bool(left.any()):
            return out.reshape(shape)
        rows, count = rows[left], count[left]
        h = keccak_f(_onion_input(h[left]))[:, :4]
