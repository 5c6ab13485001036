"""Poseidon width-12 hashing over Goldilocks: host ints and device tensors.

Semantics match the reference permutation exactly: 4 full rounds, 22
partial rounds, 4 full rounds, x^7 S-box, round constants
ALL_ROUND_CONSTANTS[i + 12 * round], MDS
``out[r] = sum_i CIRC[i] s[(i + r) % 12] + DIAG[r] s[r]``
(reference plonky2/src/hash/poseidon_goldilocks.rs:95-108,301-302).

The host functions (python ints) serve the Fiat-Shamir challenger, the
public-input hash and the verifier's Merkle checks; the ``*_a`` functions
run the permutation over an algebra for the PoseidonGate's host
constraints.  The device functions take tensors with the JAX
package's layout (states (..., 12), inputs (..., L)) and reach the kernels
of ``ops/poseidon_gl.py`` for CUDA tensors.
"""

from __future__ import annotations

from operator import mul
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
# its rows as python ints, and the columns of the fast schedule's initial
# matrix, for the host permutation
_MDS_ROWS = [[int(v) for v in row] for row in _MDS]
_INIT_COLS = [[C.FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1]
               for r in range(1, WIDTH)] for c in range(1, WIDTH)]
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
    return [sum(map(mul, row, state)) % P for row in _MDS_ROWS]


def permute_host(state: Sequence[int]) -> List[int]:
    """The width-12 Poseidon permutation on 12 canonical ints, through the
    reference's fast partial rounds (the same permutation in a fifth of
    the naive schedule's multiplications; the verifier's Merkle checks
    run thousands of them)."""
    assert len(state) == WIDTH
    s = [x % P for x in state]
    for r in range(C.HALF_N_FULL_ROUNDS):
        s = mds_layer_host(sbox_layer_host(constant_layer_host(s, r)))
    s = mds_partial_layer_init_host(partial_first_constant_layer_host(s))
    for r in range(C.N_PARTIAL_ROUNDS):
        s[0] = sbox_host(s[0])
        if r < C.N_PARTIAL_ROUNDS - 1:
            s[0] = (s[0] + C.FAST_PARTIAL_ROUND_CONSTANTS[r]) % P
        s = mds_partial_layer_fast_host(s, r)
    for r in range(C.HALF_N_FULL_ROUNDS):
        s = mds_layer_host(sbox_layer_host(constant_layer_host(
            s, C.HALF_N_FULL_ROUNDS + C.N_PARTIAL_ROUNDS + r)))
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
    tail = state[1:]
    return [state[0]] + [sum(map(mul, col, tail)) % P for col in _INIT_COLS]


def mds_partial_layer_fast_host(state: List[int], r: int) -> List[int]:
    mds0to0 = C.MDS_MATRIX_CIRC[0] + C.MDS_MATRIX_DIAG[0]
    s0, tail = state[0], state[1:]
    d = mds0to0 * s0 + sum(map(mul, C.FAST_PARTIAL_ROUND_W_HATS[r], tail))
    return [d % P] + [(v * s0 + x) % P
                      for v, x in zip(C.FAST_PARTIAL_ROUND_VS[r], tail)]


def hash_or_noop_host(inputs: Sequence[int]) -> List[int]:
    """Up to 4 elements: zero-padded as they are; more: the sponge hash
    (reference plonk/config.rs:70-84)."""
    if len(inputs) <= NUM_HASH_OUT:
        return list(inputs) + [0] * (NUM_HASH_OUT - len(inputs))
    return hash_no_pad_host(inputs)


def two_to_one_host(x: Sequence[int], y: Sequence[int]) -> List[int]:
    """Merkle compression (reference hash/hashing.rs:76-97)."""
    state = list(x) + list(y) + [0] * (WIDTH - 2 * NUM_HASH_OUT)
    return permute_host(state)[:NUM_HASH_OUT]


# The same fast schedule over an algebra ``A`` (``gates/base.py``): the
# PoseidonGate's host constraints at zeta (the JAX package's
# ``hash/poseidon_gl.py:134-204``).


def constant_layer_a(A, state, round_ctr: int):
    return [A.add_base_const(s, C.ALL_ROUND_CONSTANTS[i + WIDTH * round_ctr])
            for i, s in enumerate(state)]


def sbox_monomial_a(A, x):
    return A.exp7(x)


def sbox_layer_a(A, state):
    return [sbox_monomial_a(A, s) for s in state]


def mds_row_shf_a(A, r: int, v):
    res = A.zero()
    for i in range(WIDTH):
        res = A.const_mul_add(C.MDS_MATRIX_CIRC[i], v[(i + r) % WIDTH], res)
    return A.const_mul_add(C.MDS_MATRIX_DIAG[r], v[r], res)


def mds_gate_fits(A) -> bool:
    """Whether ``A`` builds a circuit whose routed wires hold a
    PoseidonMdsGate (two extension elements a lane); the gate's in-circuit
    MDS layers go through one then (reference poseidon_goldilocks.rs:
    597-620)."""
    hook = getattr(A, "poseidon_mds_layer", None)
    return hook is not None and A.b.config.num_routed_wires >= \
        2 * A.spec.ext_degree * WIDTH


def mds_layer_a(A, state):
    if mds_gate_fits(A):
        return A.poseidon_mds_layer(state)
    return [mds_row_shf_a(A, r, state) for r in range(WIDTH)]


def partial_first_constant_layer_a(A, state):
    return [A.add_base_const(s, C.FAST_PARTIAL_FIRST_ROUND_CONSTANT[i])
            for i, s in enumerate(state)]


def mds_partial_layer_init_a(A, state):
    result = [A.zero()] * WIDTH
    result[0] = state[0]
    for r in range(1, WIDTH):
        for c in range(1, WIDTH):
            result[c] = A.const_mul_add(
                C.FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1],
                state[r], result[c])
    return result


def mds_partial_layer_fast_a(A, state, r: int):
    mds0to0 = C.MDS_MATRIX_CIRC[0] + C.MDS_MATRIX_DIAG[0]
    d = A.const_mul(mds0to0, state[0])
    for i in range(1, WIDTH):
        d = A.const_mul_add(C.FAST_PARTIAL_ROUND_W_HATS[r][i - 1],
                            state[i], d)
    return [d] + [A.const_mul_add(C.FAST_PARTIAL_ROUND_VS[r][i - 1],
                                  state[0], state[i])
                  for i in range(1, WIDTH)]


def permute_fast_a(A, state):
    """The whole permutation through the fast partial rounds, over any
    algebra; equals ``permute_host``."""
    round_ctr = 0
    for _ in range(C.HALF_N_FULL_ROUNDS):
        state = mds_layer_a(A, sbox_layer_a(
            A, constant_layer_a(A, state, round_ctr)))
        round_ctr += 1
    state = mds_partial_layer_init_a(
        A, partial_first_constant_layer_a(A, state))
    for r in range(C.N_PARTIAL_ROUNDS):
        state[0] = sbox_monomial_a(A, state[0])
        if r < C.N_PARTIAL_ROUNDS - 1:
            state[0] = A.add_base_const(state[0],
                                        C.FAST_PARTIAL_ROUND_CONSTANTS[r])
        state = mds_partial_layer_fast_a(A, state, r)
    round_ctr += C.N_PARTIAL_ROUNDS
    for _ in range(C.HALF_N_FULL_ROUNDS):
        state = mds_layer_a(A, sbox_layer_a(
            A, constant_layer_a(A, state, round_ctr)))
        round_ctr += 1
    return state


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
