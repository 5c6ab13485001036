"""KeccakHash<25>, the Merkle and transcript hasher of the reference's
KeccakGoldilocksConfig (plonky2/src/plonk/config.rs:208-216; hash/
keccak.rs:14-126; the JAX package's ``hash/keccak_hasher.py``).

Digests are the first 25 bytes of a Keccak-256: ``bytes`` on the host and
(..., 25) ``uint8`` tensors on the device.  Keccak is not an algebraic
hasher: it commits the Merkle trees and runs the Fiat-Shamir transcript,
while the circuit's gadgets and the public-input hash stay with the
field's own Poseidon (the config's InnerHasher).  Only Goldilocks has a
Keccak config in the reference.

The module protocol is the one of ``hash/poseidon_gl.py``: the host
functions (python ints and bytes) serve the challenger, the circuit
digest and the verifier; the device functions reach the kernels of
``ops/keccak.py`` for CUDA tensors.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..field import gl
from ..field.host import GOLDILOCKS
from ..ops import keccak as K
from ..utils.keccak import keccak256
from . import keccak_device as kd

HASH_SIZE = K.DIGEST       # 25 bytes
DIGEST_IS_BYTES = True     # serialised as HASH_SIZE raw bytes (BytesHash)
WIDTH = K.WIDTH            # the hash-onion's state: 12 elements
RATE = 8
F = gl                     # the leaves' field
P = GOLDILOCKS.p
# a byte digest observed by the challenger: 7-byte little-endian chunks
# (reference hash_types.rs:259-286)
CHUNK = 7
merkle_levels = K.merkle_levels


# --------------------------------------------------------------------------
# host (python ints and bytes)
# --------------------------------------------------------------------------


def _elems_to_bytes(elems: Sequence[int]) -> bytes:
    return b"".join(int(e).to_bytes(8, "little") for e in elems)


def hash_no_pad_host(elems: Sequence[int]) -> bytes:
    return keccak256(_elems_to_bytes(elems))[:HASH_SIZE]


def two_to_one_host(left: bytes, right: bytes) -> bytes:
    return keccak256(bytes(left) + bytes(right))[:HASH_SIZE]


def hash_or_noop_host(elems: Sequence[int]) -> bytes:
    """The elements' bytes zero-padded when they fit in a digest (reference
    hash/hashing.rs hash_or_noop: len * 8 <= HASH_SIZE), else their hash."""
    if len(elems) * 8 <= HASH_SIZE:
        return _elems_to_bytes(elems).ljust(HASH_SIZE, b"\x00")
    return hash_no_pad_host(elems)


def digest_to_elements(digest: bytes) -> List[int]:
    """A byte digest as field elements: 7-byte little-endian chunks
    (reference hash_types.rs:269-275)."""
    return [int.from_bytes(digest[i:i + CHUNK], "little")
            for i in range(0, len(digest), CHUNK)]


def permute_host(state: Sequence[int]) -> List[int]:
    """The hash-onion with rejection sampling into F (reference
    keccak.rs:63-98): the 96 state bytes hashed, then each hash again,
    every 8-byte word below p taken until 12 are."""
    assert len(state) == WIDTH
    data = _elems_to_bytes(state)
    out: List[int] = []
    while len(out) < WIDTH:
        data = keccak256(data)
        for i in range(0, 32, 8):
            word = int.from_bytes(data[i:i + 8], "little")
            if word < P and len(out) < WIDTH:
                out.append(word)
    return out


# --------------------------------------------------------------------------
# device (batched tensors)
# --------------------------------------------------------------------------


def hash_or_noop(leaves: torch.Tensor) -> torch.Tensor:
    """Goldilocks leaf rows (n, L) of canonical elements -> (n, 25) uint8
    digests: a leaf of at most 3 elements is its bytes, zero-padded."""
    msg = kd.gl_to_bytes(leaves)                         # (n, 8 L)
    if msg.shape[-1] <= HASH_SIZE:
        return torch.nn.functional.pad(msg, (0, HASH_SIZE - msg.shape[-1]))
    return K.hash_rows(msg, HASH_SIZE)


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(n, 25) uint8 x2 -> (n, 25) uint8."""
    return K.hash_rows(torch.cat([left, right], dim=-1), HASH_SIZE)


def permute(state: torch.Tensor) -> torch.Tensor:
    """The batched hash-onion of states (..., 12)."""
    return K.permute(state)
