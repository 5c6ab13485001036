"""Poseidon2 width-16 hashing over BabyBear: host ints and device tensors.

Semantics follow the reference's native evaluation exactly
(plonky2/src/gates/poseidon2_babybear.rs:700-995, the JAX package's
``hash/poseidon2_bb.py``): the initial external layer, 4 full rounds
(add EXTERNAL_CONSTANTS[r], x^7 on every lane, external layer), 13
partial rounds (lane 0 += INTERNAL_CONSTANTS[r], x^7 on lane 0, internal
layer), 4 more full rounds.  The external layer is a blockwise 4x4 M4 plus
per-congruence-class block sums; the internal layer scales every lane by
INTERNAL_SCALE, then head = sum(lanes 1..15) - lane 0 and lane i = sum(all)
+ lane i * 2^shift_(i-1).  Digests have 8 elements; ``two_to_one`` permutes
the 16 lanes of (left || right).

The host functions (canonical python ints) serve the Fiat-Shamir
challenger, the public-input hash and the verifier's Merkle checks; the
``*_a`` functions run the permutation over an algebra for the gate's host
constraints.  The device functions take BabyBear
Montgomery tensors in the JAX package's layout (states (..., 16), inputs
(..., L)) and reach the kernels of ``ops/poseidon2_bb.py`` for CUDA
tensors.  A hasher module: WIDTH, RATE, NUM_HASH_OUT, F, host and device
permute, the sponges, ``two_to_one`` and ``merkle_levels``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..field import bb
from ..field.host import BABYBEAR
from ..ops import poseidon2_bb as K
from . import _poseidon2_bb_constants as C

F = bb
P = BABYBEAR.p
WIDTH = C.SPONGE_WIDTH                      # 16
RATE = C.SPONGE_RATE                        # 8
NUM_HASH_OUT = BABYBEAR.num_hash_out_elts   # 8
merkle_levels = K.merkle_levels


# --------------------------------------------------------------------------
# host (python ints)
# --------------------------------------------------------------------------


def _mat4(x: List[int]) -> List[int]:
    x0, x1, x2, x3 = x
    t = x0 + x1 + x2 + x3
    return [(t + x0 + 2 * x1) % P, (t + x1 + 2 * x2) % P,
            (t + x2 + 2 * x3) % P, (t + x3 + 2 * x0) % P]


def external_layer_host(s: List[int]) -> List[int]:
    out = []
    for i in range(0, WIDTH, 4):
        out.extend(_mat4(s[i:i + 4]))
    sums = [sum(out[k::4]) for k in range(4)]
    return [(out[i] + sums[i % 4]) % P for i in range(WIDTH)]


def internal_layer_host(s: List[int]) -> List[int]:
    s = [x * C.INTERNAL_SCALE % P for x in s]
    part = sum(s[1:])
    full = part + s[0]
    return [(part - s[0]) % P] + [
        (full + x * (1 << k)) % P
        for x, k in zip(s[1:], C.INTERNAL_DIAG_SHIFTS)]


def sbox_host(x: int) -> int:
    return pow(x, 7, P)


def permute_host(state: Sequence[int]) -> List[int]:
    """The width-16 Poseidon2 permutation on 16 canonical ints."""
    assert len(state) == WIDTH
    s = external_layer_host([int(x) % P for x in state])
    for r in range(C.N_FULL_ROUNDS_TOTAL):
        if r == C.HALF_N_FULL_ROUNDS:
            for rc in C.INTERNAL_CONSTANTS:
                s[0] = sbox_host((s[0] + rc) % P)
                s = internal_layer_host(s)
        s = external_layer_host([sbox_host((x + c) % P)
                            for x, c in zip(s, C.EXTERNAL_CONSTANTS[r])])
    return s


def hash_n_to_m_no_pad_host(inputs: Sequence[int],
                            num_outputs: int) -> List[int]:
    """Overwrite-mode sponge (reference hash/hashing.rs:100-124)."""
    state = [0] * WIDTH
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i:i + RATE]
        state[:len(chunk)] = [int(x) % P for x in chunk]
        state = permute_host(state)
    outputs: List[int] = []
    while True:
        for x in state[:RATE]:
            outputs.append(x)
            if len(outputs) == num_outputs:
                return outputs
        state = permute_host(state)


def hash_no_pad_host(inputs: Sequence[int]) -> List[int]:
    return hash_n_to_m_no_pad_host(inputs, NUM_HASH_OUT)


def hash_or_noop_host(inputs: Sequence[int]) -> List[int]:
    """Up to 8 elements: zero-padded as they are; more: the sponge hash."""
    if len(inputs) <= NUM_HASH_OUT:
        return list(inputs) + [0] * (NUM_HASH_OUT - len(inputs))
    return hash_no_pad_host(inputs)


def two_to_one_host(x: Sequence[int], y: Sequence[int]) -> List[int]:
    """Merkle compression: the permutation of the 16 lanes of (x || y)."""
    state = list(x) + list(y)
    assert len(state) == WIDTH
    return permute_host(state)[:NUM_HASH_OUT]


# The permutation over an algebra ``A`` (``gates/base.py``): the
# Poseidon2BabyBearGate's host constraints (reference
# gates/poseidon2_babybear.rs:787-995; the JAX package's
# ``hash/poseidon2_bb.py:46-94``).


def apply_mat4_a(A, x: List) -> List:
    t01 = A.add(x[0], x[1])
    t23 = A.add(x[2], x[3])
    t0123 = A.add(t01, t23)
    t01123 = A.add(t0123, x[1])
    t01233 = A.add(t0123, x[3])
    x3 = A.add(t01233, A.add(x[0], x[0]))
    x1 = A.add(t01123, A.add(x[2], x[2]))
    x0 = A.add(t01123, t01)
    x2 = A.add(t01233, t23)
    return [x0, x1, x2, x3]


def external_layer_a(A, state: List) -> List:
    out = []
    for i in range(0, WIDTH, 4):
        out.extend(apply_mat4_a(A, state[i:i + 4]))
    sums = []
    for k in range(4):
        acc = out[k]
        for j in range(4, WIDTH, 4):
            acc = A.add(acc, out[j + k])
        sums.append(acc)
    return [A.add(out[i], sums[i % 4]) for i in range(WIDTH)]


def internal_layer_a(A, state: List) -> List:
    state = [A.mul_base_const(x, C.INTERNAL_SCALE) for x in state]
    part_sum = state[1]
    for x in state[2:]:
        part_sum = A.add(part_sum, x)
    full_sum = A.add(part_sum, state[0])
    out = [A.sub(part_sum, state[0])]
    for i, shift in enumerate(C.INTERNAL_DIAG_SHIFTS):
        out.append(A.add(full_sum,
                         A.mul_base_const(state[i + 1], 1 << shift)))
    return out


def sbox_a(A, x):
    x2 = A.mul(x, x)
    x3 = A.mul(x2, x)
    return A.mul(x3, A.mul(x2, x2))


def permute_a(A, state: List) -> List:
    """The whole permutation over any algebra; equals ``permute_host``."""
    assert len(state) == WIDTH
    state = external_layer_a(A, state)
    for r in range(C.HALF_N_FULL_ROUNDS):
        state = external_layer_a(A, [
            sbox_a(A, A.add_base_const(x, c))
            for x, c in zip(state, C.EXTERNAL_CONSTANTS[r])])
    for r in range(C.N_PARTIAL_ROUNDS):
        state[0] = sbox_a(A, A.add_base_const(state[0],
                                              C.INTERNAL_CONSTANTS[r]))
        state = internal_layer_a(A, state)
    for r in range(C.HALF_N_FULL_ROUNDS, C.N_FULL_ROUNDS_TOTAL):
        state = external_layer_a(A, [
            sbox_a(A, A.add_base_const(x, c))
            for x, c in zip(state, C.EXTERNAL_CONSTANTS[r])])
    return state


# --------------------------------------------------------------------------
# device (batched Montgomery tensors)
# --------------------------------------------------------------------------


def permute(state: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon2 permutation; state (..., 16)."""
    return K.permute(state)


def hash_n_to_m_no_pad(inputs: torch.Tensor, num_outputs: int
                       ) -> torch.Tensor:
    """Batched sponge: inputs (..., L), L >= 1 -> (..., num_outputs)."""
    shape = inputs.shape
    flat = inputs.reshape(-1, shape[-1])
    if num_outputs <= RATE:
        out = K.hash_leaves(flat, num_outputs)
    else:
        state = K.hash_leaves(flat, WIDTH)
        outs = [state[:, :RATE]]
        while RATE * len(outs) < num_outputs:
            state = permute(state)
            outs.append(state[:, :RATE])
        out = torch.cat(outs, dim=-1)[:, :num_outputs]
    return out.reshape(shape[:-1] + (num_outputs,))


def hash_no_pad(inputs: torch.Tensor) -> torch.Tensor:
    return hash_n_to_m_no_pad(inputs, NUM_HASH_OUT)


def hash_or_noop(inputs: torch.Tensor) -> torch.Tensor:
    length = inputs.shape[-1]
    if length <= NUM_HASH_OUT:
        pad = NUM_HASH_OUT - length
        return torch.nn.functional.pad(inputs, (0, pad)) if pad else inputs
    return hash_no_pad(inputs)


def two_to_one(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched Merkle compression: x, y (..., 8) -> (..., 8)."""
    return permute(torch.cat([x, y], dim=-1))[..., :NUM_HASH_OUT]
