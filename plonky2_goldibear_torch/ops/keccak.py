"""Keccak kernels (``csrc/keccak.cu``) and their plain torch versions (on
``hash/keccak_device.py``): the digest of each row of bytes, the Merkle
levels over 25-byte digests, and the hash-onion permutation of Goldilocks
states.

The JAX package has no Pallas kernel for Keccak: its device program is
jnp (``plonky2_goldibear_tpu/hash/keccak_device.py:keccak_f``).  On the
H100 the kernels are bound by their 32-bit integer instructions (at least
4,320 a Keccak-f, against at most 161 bytes a block); the design is one
thread a message (see the note in the source).  Layouts follow the JAX
package's public functions: rows (n, L) uint8, digests (n, 25) uint8 in
natural node order, states (..., 12) int64 Goldilocks bit patterns.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; there is no other dispatch.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from ..hash import keccak_device as kd
from . import record

DIGEST = 25            # bytes of a digest (the reference's HASH_SIZE)
WIDTH = kd.WIDTH       # 12 Goldilocks elements a hash-onion state

launches = {"keccak_rows": 0, "keccak_merkle_levels": 0,
            "keccak_permute": 0}


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
# kernel wrappers
# --------------------------------------------------------------------------

_BOUND = set()


def _lib():
    from . import _build

    lib = _build.lib("keccak")
    if "keccak" not in _BOUND:
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.keccak_rows.argtypes = [vp, vp, ll, i32, i32, i32, vp]
        lib.keccak_merkle_levels.argtypes = [vp, vp, ll, i32, vp]
        lib.keccak_permute.argtypes = [vp, vp, ll, vp]
        _BOUND.add("keccak")
    return lib


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
    ``hash_rows_plain``: 1 <= out_bytes <= 32."""
    if rows.ndim != 2 or not 1 <= out_bytes <= 32:
        raise ValueError(f"hash_rows needs (n, L) rows and 1 to 32 output "
                         f"bytes, got {tuple(rows.shape)}, {out_bytes}")
    _check(rows, torch.uint8, "hash_rows")
    if _on_cpu(rows, "hash_rows"):
        return hash_rows_plain(rows, out_bytes)
    from . import _build

    rows = rows.contiguous()
    n, length = rows.shape
    out = torch.empty((n, out_bytes), dtype=torch.uint8, device=rows.device)
    aligned = length % 8 == 0 and rows.data_ptr() % 8 == 0
    record("keccak_rows", n, length)
    err = _lib().keccak_rows(rows.data_ptr(), out.data_ptr(), n, length,
                             out_bytes, int(aligned),
                             _build.stream_ptr(rows.device))
    _build.check(err, "keccak_rows")
    launches["keccak_rows"] += 1
    return out


def merkle_levels(d0: torch.Tensor, num_layers: int) -> List[torch.Tensor]:
    """Digest levels above d0 (n, 25), as ``merkle_levels_plain``: one
    launch a level."""
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
    from . import _build

    d0 = d0.contiguous()
    sizes = [n >> (k + 1) for k in range(num_layers)]
    out = torch.empty((sum(sizes), DIGEST), dtype=torch.uint8,
                      device=d0.device)
    record("keccak_merkle_levels", n, num_layers)
    err = _lib().keccak_merkle_levels(d0.data_ptr(), out.data_ptr(), n,
                                      num_layers,
                                      _build.stream_ptr(d0.device))
    _build.check(err, "keccak_merkle_levels")
    launches["keccak_merkle_levels"] += num_layers
    return list(torch.split(out, sizes, dim=0))


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
                                _build.stream_ptr(state.device))
    _build.check(err, "keccak_permute")
    launches["keccak_permute"] += 1
    return out
