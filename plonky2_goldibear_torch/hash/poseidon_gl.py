"""Poseidon width-12 hashing over Goldilocks: host ints and device tensors.

Semantics match the reference permutation exactly: 4 full rounds, 22
partial rounds, 4 full rounds, x^7 S-box, round constants
ALL_ROUND_CONSTANTS[i + 12 * round], MDS
``out[r] = sum_i CIRC[i] s[(i + r) % 12] + DIAG[r] s[r]``
(reference plonky2/src/hash/poseidon_goldilocks.rs:95-108,301-302).

The host functions (python ints) serve the Fiat-Shamir challenger and the
public-input hash.  The device functions take tensors with the JAX
package's layout (states (..., 12), inputs (..., L)) and reach the kernels
of ``ops/poseidon_gl.py`` for CUDA tensors.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..field import gl
from ..field.host import GOLDILOCKS
from ..ops import poseidon_gl as K
from . import _poseidon_gl_constants as C

F = gl
P = GOLDILOCKS.p
WIDTH = C.SPONGE_WIDTH
RATE = C.SPONGE_RATE
NUM_HASH_OUT = GOLDILOCKS.num_hash_out_elts  # 4
_MDS = K._MDS
merkle_levels = K.merkle_levels


# --------------------------------------------------------------------------
# host (python ints)
# --------------------------------------------------------------------------


def sbox_host(x: int) -> int:
    x2 = x * x % P
    x3 = x2 * x % P
    x4 = x2 * x2 % P
    return x3 * x4 % P


def mds_layer_host(state: List[int]) -> List[int]:
    return [sum(int(_MDS[r, j]) * state[j] for j in range(WIDTH)) % P
            for r in range(WIDTH)]


def permute_host(state: Sequence[int]) -> List[int]:
    """The width-12 Poseidon permutation on 12 canonical ints."""
    assert len(state) == WIDTH
    s = [x % P for x in state]
    round_ctr = 0
    for phase in range(3):
        n = C.HALF_N_FULL_ROUNDS if phase != 1 else C.N_PARTIAL_ROUNDS
        full = phase != 1
        for _ in range(n):
            rc = C.ALL_ROUND_CONSTANTS[WIDTH * round_ctr:
                                       WIDTH * (round_ctr + 1)]
            s = [(x + c) % P for x, c in zip(s, rc)]
            if full:
                s = [sbox_host(x) for x in s]
            else:
                s[0] = sbox_host(s[0])
            s = mds_layer_host(s)
            round_ctr += 1
    return s


def hash_n_to_m_no_pad_host(inputs: Sequence[int],
                            num_outputs: int) -> List[int]:
    """Overwrite-mode sponge (reference hash/hashing.rs:100-124)."""
    state = [0] * WIDTH
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i:i + RATE]
        state[:len(chunk)] = [x % P for x in chunk]
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


# The reference's fast partial-round schedule on host ints
# (poseidon_goldilocks.rs:632-812; the JAX package's
# ``hash/poseidon_gl.py:134-200``, there over an algebra), with
# ``mds_layer_host`` and ``sbox_host`` above: the PoseidonGate generator
# fills its partial S-box wires with state[0] of this form.


def constant_layer_host(state: List[int], round_ctr: int) -> List[int]:
    rc = C.ALL_ROUND_CONSTANTS[WIDTH * round_ctr:WIDTH * (round_ctr + 1)]
    return [(x + c) % P for x, c in zip(state, rc)]


def sbox_layer_host(state: List[int]) -> List[int]:
    return [sbox_host(x) for x in state]


def partial_first_constant_layer_host(state: List[int]) -> List[int]:
    return [(x + c) % P
            for x, c in zip(state, C.FAST_PARTIAL_FIRST_ROUND_CONSTANT)]


def mds_partial_layer_init_host(state: List[int]) -> List[int]:
    m = C.FAST_PARTIAL_ROUND_INITIAL_MATRIX
    return [state[0]] + [
        sum(m[r - 1][c - 1] * state[r] for r in range(1, WIDTH)) % P
        for c in range(1, WIDTH)]


def mds_partial_layer_fast_host(state: List[int], r: int) -> List[int]:
    mds0to0 = C.MDS_MATRIX_CIRC[0] + C.MDS_MATRIX_DIAG[0]
    d = mds0to0 * state[0] + sum(
        w * x for w, x in zip(C.FAST_PARTIAL_ROUND_W_HATS[r], state[1:]))
    return [d % P] + [(v * state[0] + x) % P
                      for v, x in zip(C.FAST_PARTIAL_ROUND_VS[r], state[1:])]


# --------------------------------------------------------------------------
# device (batched tensors)
# --------------------------------------------------------------------------


def permute(state: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon permutation; state (..., 12)."""
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
    """Batched Merkle compression: x, y (..., 4) -> (..., 4)."""
    zero = torch.zeros_like(x)
    state = torch.cat([x, y, zero], dim=-1)
    return permute(state)[..., :NUM_HASH_OUT]
