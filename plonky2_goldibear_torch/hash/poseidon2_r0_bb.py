"""Poseidon2-risc0 width 24 over BabyBear: host ints and plain torch.

The risc0 parameterisation of Poseidon2 (reference
plonky2/src/hash/poseidon2_risc0_babybear.rs:22-230,
gates/poseidon2_risc0_babybear.rs:678-860; the JAX package's
``hash/poseidon2_r0_bb.py``): the external layer is the Horizen Labs M4
block ([[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]], by the add chain of
``apply_hl_mat4``) then each lane plus the sum of its congruence class over
the six blocks; the internal layer is sum(state) + M_INT_DIAG_HZN[i] *
state[i]; 4 + 4 full rounds around 21 partial rounds, x^7 S-box.  The
sponge has rate 16 and capacity 8, digests of 8 elements, and absorbs by
overwriting the whole rate part (a short chunk is zero-filled).

It is an in-circuit hasher (``CircuitBuilder.hash_or_noop(inputs,
hasher=poseidon2_r0_bb)`` places ``Poseidon2R0BabyBearGate`` rows); the
commitments and the transcript stay on the builder's own hasher, which is
what ``IN_CIRCUIT_ONLY``, ``ZERO_FILL`` and ``permutation_gate`` tell the
builder.  ``permute_a`` is the one round schedule, over any algebra: the
host functions (python ints) run it for ``circuits.r0_hash``'s expected
digest and the tests, the gate runs it for its constraints and its witness generator,
and ``permute`` and the device sponges run it over ``DeviceBaseAlgebra``
as the plain-torch twin on BabyBear Montgomery tensors.  The JAX package
has no Pallas kernel for this permutation, so it has no hand kernel here.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..field import bb
from ..field.host import BABYBEAR
from . import _poseidon2_r0_bb_constants as C

F = bb
P = BABYBEAR.p
WIDTH = C.SPONGE_WIDTH          # 24
RATE = C.SPONGE_RATE            # 16
CAPACITY = C.SPONGE_CAPACITY    # 8
NUM_HASH_OUT = C.SPONGE_CAPACITY
IN_CIRCUIT_ONLY = True   # never the builder's own (commitment) hasher
ZERO_FILL = True         # a short chunk is zero-filled to the rate


def permutation_gate(config):
    """The gate a hashing gadget places for one permutation."""
    # imported here: the gate module imports this one
    from ..gates.poseidon2_r0_bb_gate import Poseidon2R0BabyBearGate
    return Poseidon2R0BabyBearGate.from_config(config)


# --------------------------------------------------------------------------
# over an algebra (the gate's constraints and the host functions)
# --------------------------------------------------------------------------


def apply_hl_mat4_a(A, x: List) -> List:
    """The HL M4 block by the reference's add chain
    (gates/poseidon2_risc0_babybear.rs:841-857)."""
    t0 = A.add(x[0], x[1])
    t1 = A.add(x[2], x[3])
    t2 = A.add(A.add(x[1], x[1]), t1)
    t3 = A.add(A.add(x[3], x[3]), t0)
    t4 = A.add(A.mul_base_const(t1, 4), t3)
    t5 = A.add(A.mul_base_const(t0, 4), t2)
    t6 = A.add(t3, t5)
    t7 = A.add(t2, t4)
    return [t6, t5, t7, t4]


def external_layer_a(A, state: List) -> List:
    """permute_external_mut (:738-767)."""
    out = []
    for i in range(0, WIDTH, 4):
        out.extend(apply_hl_mat4_a(A, state[i:i + 4]))
    sums = []
    for k in range(4):
        acc = out[k]
        for j in range(4, WIDTH, 4):
            acc = A.add(acc, out[j + k])
        sums.append(acc)
    return [A.add(out[i], sums[i % 4]) for i in range(WIDTH)]


def internal_layer_a(A, state: List) -> List:
    """permute_internal_mut (:731-737): sum + diag_i * x_i."""
    total = state[0]
    for x in state[1:]:
        total = A.add(total, x)
    return [A.add(total, A.mul_base_const(state[i], C.M_INT_DIAG_HZN[i]))
            for i in range(WIDTH)]


def sbox_a(A, x):
    x2 = A.mul(x, x)
    x3 = A.mul(x2, x)
    return A.mul(x3, A.mul(x2, x2))


def _no_record(stage, r, i, x):
    return x


def _full_round(A, state, stage, r, round_constants, at_sbox):
    # lane by lane, each step over all lanes: a circuit algebra places its
    # gates in this order, the JAX package's
    xs = [A.add_base_const(x, c) for x, c in zip(state, round_constants)]
    xs = [at_sbox(stage, r, i, x) for i, x in enumerate(xs)]
    return external_layer_a(A, [sbox_a(A, x) for x in xs])


def permute_a(A, state: List, at_sbox=_no_record) -> List:
    """The whole permutation over any algebra; equals ``permute_host``.

    The port's one round schedule.  ``at_sbox(stage, r, i, x)`` sees each
    S-box input ``x`` and returns the value the S-box takes: stage 0 is the
    first four full rounds, 1 the partial rounds (lane 0), 2 the last four
    full rounds, ``r`` counts rounds within its stage and ``i`` is the
    lane.  The gate's constraints and its generator pass one to read or
    record the stored S-box inputs."""
    assert len(state) == WIDTH
    state = external_layer_a(A, state)
    for r in range(C.HALF_N_FULL_ROUNDS):
        state = _full_round(A, state, 0, r, C.EXTERNAL_CONSTANTS[r], at_sbox)
    for r in range(C.N_PARTIAL_ROUNDS):
        x = at_sbox(1, r, 0, A.add_base_const(state[0],
                                              C.INTERNAL_CONSTANTS[r]))
        state = internal_layer_a(A, [sbox_a(A, x)] + state[1:])
    for r in range(C.HALF_N_FULL_ROUNDS):
        state = _full_round(
            A, state, 2, r,
            C.EXTERNAL_CONSTANTS[C.HALF_N_FULL_ROUNDS + r], at_sbox)
    return state


def _sponge(A, zero, inputs: List, num_outputs: int) -> List:
    """The sponge over an algebra; a short last chunk is zero-filled to
    the rate (poseidon2_risc0_babybear.rs:205-212)."""
    state = [zero] * WIDTH
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i:i + RATE]
        state = permute_a(A, chunk + [zero] * (RATE - len(chunk))
                          + state[RATE:])
    outputs: List = []
    while True:
        for x in state[:RATE]:
            outputs.append(x)
            if len(outputs) == num_outputs:
                return outputs
        state = permute_a(A, state)


# --------------------------------------------------------------------------
# host (python ints)
# --------------------------------------------------------------------------


class _HostA:
    """Canonical python ints mod p."""

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    mul_base_const = mul
    add_base_const = add


def permute_host(state: Sequence[int]) -> List[int]:
    return permute_a(_HostA, [int(x) % P for x in state])


def hash_n_to_m_no_pad_host(inputs: Sequence[int],
                            num_outputs: int) -> List[int]:
    return _sponge(_HostA, 0, [int(x) % P for x in inputs], num_outputs)


def hash_no_pad_host(inputs: Sequence[int]) -> List[int]:
    return hash_n_to_m_no_pad_host(inputs, NUM_HASH_OUT)


def hash_or_noop_host(inputs: Sequence[int]) -> List[int]:
    if len(inputs) <= NUM_HASH_OUT:
        return list(inputs) + [0] * (NUM_HASH_OUT - len(inputs))
    return hash_no_pad_host(inputs)


def two_to_one_host(x: Sequence[int], y: Sequence[int]) -> List[int]:
    return permute_host(list(x) + list(y) + [0] * CAPACITY)[:NUM_HASH_OUT]


# --------------------------------------------------------------------------
# plain torch: the same schedule over ``DeviceBaseAlgebra``, one lane a
# tensor; states (..., 24) and inputs (..., L) of Montgomery forms, the
# JAX package's layout
# --------------------------------------------------------------------------


def _device_a(device):
    # imported here: the gates package imports this module
    from ..gates.base import DeviceBaseAlgebra
    return DeviceBaseAlgebra(bb, device)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Batched permutation; state (..., 24)."""
    return torch.stack(permute_a(_device_a(state.device),
                                 list(state.unbind(-1))), dim=-1)


def hash_n_to_m_no_pad(inputs: torch.Tensor, num_outputs: int
                       ) -> torch.Tensor:
    zero = bb.zeros(inputs.shape[:-1], inputs.device)
    return torch.stack(_sponge(_device_a(inputs.device), zero,
                               list(inputs.unbind(-1)), num_outputs), dim=-1)


def hash_no_pad(inputs: torch.Tensor) -> torch.Tensor:
    return hash_n_to_m_no_pad(inputs, NUM_HASH_OUT)


def hash_or_noop(inputs: torch.Tensor) -> torch.Tensor:
    length = inputs.shape[-1]
    if length <= NUM_HASH_OUT:
        return torch.nn.functional.pad(inputs, (0, NUM_HASH_OUT - length))
    return hash_no_pad(inputs)


def two_to_one(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    zeros = bb.zeros(x.shape[:-1] + (CAPACITY,), x.device)
    return permute(torch.cat([x, y, zeros], dim=-1))[..., :NUM_HASH_OUT]
