"""PoseidonGate, constraint side: a full width-12 Poseidon permutation in
one row with a conditional-swap flag (reference
plonky2/src/gates/poseidon_goldilocks.rs).

Wire layout (reference :44-103): 12 inputs, 12 outputs, swap flag, 4 swap
deltas, then the S-box inputs of every round after the first full round.
The constraints re-run the permutation between the stored S-box inputs with
the reference's fast partial-round schedule, vectorised over the 12 lanes
and every point of the quotient domain (the JAX package's
``eval_unfiltered_device``, same values in the same order).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field import gl
from ..hash import _poseidon_gl_constants as C
from ..ops import poseidon_gl as K
from .base import Gate

W = C.SPONGE_WIDTH
HALF = C.HALF_N_FULL_ROUNDS
NP = C.N_PARTIAL_ROUNDS


def _sbox(x):
    x2 = gl.mul(x, x)
    x3 = gl.mul(x2, x)
    return gl.mul(x3, gl.mul(x2, x2))


@lru_cache(maxsize=8)
def _consts(device: str):
    def f(vals):
        return gl.from_ints(np.array(vals, dtype=np.uint64), device)

    rc = f(np.array(C.ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(30, W))
    init = np.zeros((W, W), dtype=np.uint64)       # init[c, r]
    init[0, 0] = 1
    for r in range(1, W):
        for c in range(1, W):
            init[c, r] = C.FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1]
    fast_rc = list(C.FAST_PARTIAL_ROUND_CONSTANTS[:NP - 1]) + [0]
    return {
        "rc": rc,
        "mds": torch.from_numpy(K._MDS).to(device),
        "first": f(C.FAST_PARTIAL_FIRST_ROUND_CONSTANT),
        "init": f(init),
        "fast_rc": f(fast_rc),
        "w_hats": f(C.FAST_PARTIAL_ROUND_W_HATS),
        "vs": f(C.FAST_PARTIAL_ROUND_VS),
        "mds00": C.MDS_MATRIX_CIRC[0] + C.MDS_MATRIX_DIAG[0],
    }


class PoseidonGate(Gate):
    WIRE_SWAP = 2 * W
    START_DELTA = 2 * W + 1
    START_FULL_0 = START_DELTA + 4
    START_PARTIAL = START_FULL_0 + W * (HALF - 1)
    START_FULL_1 = START_PARTIAL + NP
    END = START_FULL_1 + W * HALF

    def id(self):
        return f"PoseidonGate<WIDTH={W}>"

    def num_constraints(self):
        return W * (2 * HALF - 1) + NP + W + 1 + 4

    def eval_unfiltered_device(self, F, wires: torch.Tensor, constants,
                               pi_hash) -> torch.Tensor:
        """Constraints (123, m) over stacked Goldilocks wires
        (num_wires, m)."""
        assert F is gl, "PoseidonGate is a Goldilocks gate"
        k = _consts(str(wires.device))

        def mds(state):                       # (12, m) -> (12, m)
            return K._mds(state.t(), k["mds"]).t()

        inputs = wires[0:W]
        outputs = wires[W:2 * W]
        swap = wires[self.WIRE_SWAP]
        deltas = wires[self.START_DELTA:self.START_DELTA + 4]
        full0_w = wires[self.START_FULL_0:self.START_PARTIAL].reshape(
            HALF - 1, W, -1)
        partial_w = wires[self.START_PARTIAL:self.START_FULL_1]
        full1_w = wires[self.START_FULL_1:self.END].reshape(HALF, W, -1)

        constraints = [gl.mul(swap, gl.sub(swap, gl.ones((), swap.device)))]
        lhs, rhs = inputs[0:4], inputs[4:8]
        delta_c = gl.sub(gl.mul(swap[None], gl.sub(rhs, lhs)), deltas)
        constraints += list(delta_c)

        # swapped input state, then round 0
        state = torch.cat([gl.add(lhs, deltas), gl.sub(rhs, deltas),
                           inputs[8:W]], dim=0)
        state = mds(_sbox(gl.add(state, k["rc"][0][:, None])))
        for r in range(1, HALF):
            state = gl.add(state, k["rc"][r][:, None])
            constraints += list(gl.sub(state, full0_w[r - 1]))
            state = mds(_sbox(full0_w[r - 1]))

        # partial rounds: fast schedule
        state = gl.add(state, k["first"][:, None])
        state = gl.batch_sum(gl.mul(state[None, :, :], k["init"][:, :, None]),
                             axis=1)
        for r in range(NP):
            constraints.append(gl.sub(state[0], partial_w[r]))
            s0 = gl.add(_sbox(partial_w[r]), k["fast_rc"][r])
            tail = state[1:]
            d = gl.add(gl.mul_const(s0, k["mds00"]),
                       gl.batch_sum(gl.mul(tail, k["w_hats"][r][:, None]),
                                    axis=0))
            new_tail = gl.add(gl.mul(s0[None], k["vs"][r][:, None]), tail)
            state = torch.cat([d[None], new_tail], dim=0)

        for r in range(HALF):
            state = gl.add(state, k["rc"][HALF + NP + r][:, None])
            constraints += list(gl.sub(state, full1_w[r]))
            state = mds(_sbox(full1_w[r]))

        constraints += list(gl.sub(state, outputs))
        assert len(constraints) == self.num_constraints()
        return torch.stack(constraints)
