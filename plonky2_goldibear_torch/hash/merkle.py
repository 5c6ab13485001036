"""Merkle tree with cap over tensor leaves (reference
plonky2/src/hash/merkle_tree.rs:19,46,86-222; merkle_proofs.rs:54-80).

Leaf digest = hash_or_noop(leaf row), parent = two_to_one(left, right);
the cap (the level of 2^cap_height nodes) replaces the root, and a proof is
the sibling chain up to (excluding) the cap.  One dense digest tensor per
level in natural node order; on a CUDA tensor the leaf digests come from
the leaf-sponge kernel and the levels from the Merkle-level kernel of the
hasher (``hash/poseidon_gl.py`` or ``hash/poseidon2_bb.py``, digests of 4
or 8 elements; ``hash/keccak_hasher.py``, digests of 25 bytes, ``bytes``
on the host).  ``verify_merkle_proof_to_cap`` is the verifier's check, on
the host.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..field.host import log2_strict
from . import poseidon_gl


def build_levels(leaves: torch.Tensor, num_layers: int,
                 hasher=poseidon_gl) -> List[torch.Tensor]:
    """Leaves (n, leaf_len) -> [digests (n, NUM_HASH_OUT), level 1, ...,
    cap]."""
    d0 = hasher.hash_or_noop(leaves)
    return [d0] + hasher.merkle_levels(d0, num_layers)


class MerkleTree:
    """Merkle tree over field leaves (n_leaves, leaf_len)."""

    def __init__(self, leaves: torch.Tensor, cap_height: int,
                 hasher=poseidon_gl):
        self.hasher = hasher
        self.F = hasher.F
        self.leaves = leaves
        depth = log2_strict(leaves.shape[0])
        assert cap_height <= depth, (cap_height, depth)
        self.num_layers = depth - cap_height
        self.levels = build_levels(leaves, self.num_layers, hasher)
        self.cap = self.levels[-1]

    def _digests_host(self, digests: torch.Tensor) -> list:
        """Digests (..., d) on the host: ``bytes`` of a byte hasher, else
        lists of ints."""
        if getattr(self.hasher, "DIGEST_IS_BYTES", False):
            rows = digests.cpu().numpy()
            return [bytes(row.tobytes()) for row in rows.reshape(
                -1, rows.shape[-1])]
        return [[int(x) for x in row] for row in
                self.F.to_ints(digests).reshape(-1, digests.shape[-1])]

    def cap_host(self) -> list:
        return self._digests_host(self.cap)

    def query_gather(self, idx: torch.Tensor):
        """The leaf rows (q, leaf_len) and sibling chains (q, num_layers,
        digest) of the leaves at the device indices ``idx`` (q,), gathered
        on the device (one gather per level) and left there."""
        rows = self.leaves[idx]
        gathers = []
        for lv in self.levels[:self.num_layers]:
            gathers.append(lv[idx ^ 1])
            idx = idx >> 1
        sibs = torch.stack(gathers, dim=1) if gathers else \
            self.cap.new_empty((rows.shape[0], 0, self.cap.shape[-1]))
        return rows, sibs

    def prove_batch(self, leaf_indices: Sequence[int]) -> List[List]:
        """Sibling chains for many leaves, one gather per level and one
        transfer for all of them."""
        if self.num_layers == 0:
            return [[] for _ in leaf_indices]
        idx = torch.as_tensor(list(leaf_indices), dtype=torch.int64,
                              device=self.cap.device)
        flat = self._digests_host(self.query_gather(idx)[1])
        layers = self.num_layers
        return [flat[q * layers:(q + 1) * layers]
                for q in range(len(leaf_indices))]

    def leaf_batch(self, leaf_indices: Sequence[int]) -> List[List[int]]:
        idx = torch.as_tensor(list(leaf_indices), dtype=torch.int64,
                              device=self.leaves.device)
        rows = self.F.to_ints(self.leaves[idx])
        return [[int(x) for x in row] for row in rows]


def verify_merkle_proof_to_cap(leaf_data: Sequence[int], leaf_index: int,
                               cap: Sequence[Sequence[int]],
                               siblings: Sequence[Sequence[int]],
                               hasher=poseidon_gl) -> bool:
    """Whether the sibling chain takes the leaf to its cap node, on the
    host (reference hash/merkle_proofs.rs:54-80); digests are lists of
    ints, or ``bytes`` for a byte hasher."""
    current = hasher.hash_or_noop_host(list(leaf_data))
    index = leaf_index
    for sib in siblings:
        if index & 1:
            current = hasher.two_to_one_host(sib, current)
        else:
            current = hasher.two_to_one_host(current, sib)
        index >>= 1
    return index < len(cap) and list(current) == list(cap[index])
