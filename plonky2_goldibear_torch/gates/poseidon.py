"""PoseidonGate: a full width-12 Poseidon permutation in one row with a
conditional-swap flag (reference plonky2/src/gates/poseidon_goldilocks.rs).

Wire layout (reference :44-103): 12 inputs, 12 outputs, swap flag, 4 swap
deltas, then the S-box inputs of every round after the first full round.
The constraints re-run the permutation between the stored S-box inputs with
the reference's fast partial-round schedule, vectorised over the 12 lanes
and every point of the quotient domain (the JAX package's
``eval_unfiltered_device``, same values in the same order).
``PoseidonGenerator`` fills the wires on the host with the same fast
schedule (``hash/poseidon_gl.py`` ``*_host``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field import gl
from ..hash import _poseidon_gl_constants as C
from ..hash import poseidon_gl as pg
from ..iop import generator as gen
from ..iop import target as tgt
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
        "mds": K._tables(device)[1],              # for K._mds
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

    @staticmethod
    def wire_input(i):
        return i

    @staticmethod
    def wire_output(i):
        return W + i

    @classmethod
    def wire_delta(cls, i):
        assert i < 4
        return cls.START_DELTA + i

    @classmethod
    def wire_full_sbox_0(cls, round_, i):
        assert 0 < round_ < HALF
        return cls.START_FULL_0 + W * (round_ - 1) + i

    @classmethod
    def wire_partial_sbox(cls, round_):
        assert round_ < NP
        return cls.START_PARTIAL + round_

    @classmethod
    def wire_full_sbox_1(cls, round_, i):
        assert round_ < HALF
        return cls.START_FULL_1 + W * round_ + i

    def id(self):
        return f"PoseidonGate<WIDTH={W}>"

    def num_wires(self):
        return self.END

    def num_constants(self):
        return 0

    def degree(self):
        return 7

    def num_constraints(self):
        return W * (2 * HALF - 1) + NP + W + 1 + 4

    def generators(self, row, local_constants, spec):
        return [PoseidonGenerator(row, spec)]

    def eval_unfiltered(self, A, vars):
        """The constraints at one point over the algebra ``A``, in the
        order of ``eval_unfiltered_device`` (the JAX package's
        ``gates/poseidon.py:107``, fast partial-round schedule)."""
        lw = vars.local_wires
        swap = lw[self.WIRE_SWAP]
        constraints = [A.mul_sub(swap, swap, swap)]
        for i in range(4):
            lhs, rhs = lw[self.wire_input(i)], lw[self.wire_input(i + 4)]
            constraints.append(A.mul_sub(swap, A.sub(rhs, lhs),
                                         lw[self.wire_delta(i)]))
        state = [lw[self.wire_input(i)] for i in range(W)]
        for i in range(4):
            delta = lw[self.wire_delta(i)]
            state[i] = A.add(state[i], delta)
            state[i + 4] = A.sub(state[i + 4], delta)
        round_ctr = 0
        for r in range(HALF):
            state = pg.constant_layer_a(A, state, round_ctr)
            if r != 0:
                for i in range(W):
                    sbox_in = lw[self.wire_full_sbox_0(r, i)]
                    constraints.append(A.sub(state[i], sbox_in))
                    state[i] = sbox_in
            state = pg.mds_layer_a(A, pg.sbox_layer_a(A, state))
            round_ctr += 1
        if pg.mds_gate_fits(A):
            # the circuit algebra with room for a PoseidonMdsGate runs the
            # naive partial rounds, one MDS gate each (reference
            # poseidon_goldilocks.rs:354-363); the lane-0 S-box inputs and
            # the final state are the fast schedule's
            for r in range(NP):
                state = pg.constant_layer_a(A, state, round_ctr)
                sbox_in = lw[self.wire_partial_sbox(r)]
                constraints.append(A.sub(state[0], sbox_in))
                state[0] = pg.sbox_monomial_a(A, sbox_in)
                state = pg.mds_layer_a(A, state)
                round_ctr += 1
        else:
            state = pg.mds_partial_layer_init_a(
                A, pg.partial_first_constant_layer_a(A, state))
            for r in range(NP):
                sbox_in = lw[self.wire_partial_sbox(r)]
                constraints.append(A.sub(state[0], sbox_in))
                state[0] = pg.sbox_monomial_a(A, sbox_in)
                if r < NP - 1:
                    state[0] = A.add_base_const(
                        state[0], C.FAST_PARTIAL_ROUND_CONSTANTS[r])
                state = pg.mds_partial_layer_fast_a(A, state, r)
            round_ctr += NP
        for r in range(HALF):
            state = pg.constant_layer_a(A, state, round_ctr)
            for i in range(W):
                sbox_in = lw[self.wire_full_sbox_1(r, i)]
                constraints.append(A.sub(state[i], sbox_in))
                state[i] = sbox_in
            state = pg.mds_layer_a(A, pg.sbox_layer_a(A, state))
            round_ctr += 1
        constraints += [A.sub(state[i], lw[self.wire_output(i)])
                        for i in range(W)]
        return constraints

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


class PoseidonGenerator(gen.SimpleGenerator):
    """Fills the deltas, the S-box inputs of each round and the outputs
    (reference gates/poseidon_goldilocks.rs:438-533)."""

    def __init__(self, row: int, spec):
        self.row = row
        self.spec = spec

    def dependencies(self):
        g = PoseidonGate
        return [tgt.wire(self.row, g.wire_input(i)) for i in range(W)] + \
            [tgt.wire(self.row, g.WIRE_SWAP)]

    def run_once(self, witness, out):
        g = PoseidonGate
        row = self.row
        wv = [witness.get_target(tgt.wire(row, g.wire_input(i)))
              for i in range(W)]
        swap = witness.get_target(tgt.wire(row, g.WIRE_SWAP))
        assert swap in (0, 1), swap
        p = self.spec.p
        for i in range(4):
            out.append((tgt.wire(row, g.wire_delta(i)),
                        swap * (wv[i + 4] - wv[i]) % p))
        state = list(wv)
        if swap == 1:
            state[0:4], state[4:8] = wv[4:8], wv[0:4]

        round_ctr = 0
        for r in range(HALF):
            state = pg.constant_layer_host(state, round_ctr)
            if r != 0:
                out.extend((tgt.wire(row, g.wire_full_sbox_0(r, i)),
                            state[i]) for i in range(W))
            state = pg.mds_layer_host(pg.sbox_layer_host(state))
            round_ctr += 1

        state = pg.partial_first_constant_layer_host(state)
        state = pg.mds_partial_layer_init_host(state)
        for r in range(NP):
            out.append((tgt.wire(row, g.wire_partial_sbox(r)), state[0]))
            state[0] = pg.sbox_host(state[0])
            if r < NP - 1:
                state[0] = (state[0] + C.FAST_PARTIAL_ROUND_CONSTANTS[r]) % p
            state = pg.mds_partial_layer_fast_host(state, r)
        round_ctr += NP

        for r in range(HALF):
            state = pg.constant_layer_host(state, round_ctr)
            out.extend((tgt.wire(row, g.wire_full_sbox_1(r, i)), state[i])
                       for i in range(W))
            state = pg.mds_layer_host(pg.sbox_layer_host(state))
            round_ctr += 1

        out.extend((tgt.wire(row, g.wire_output(i)), state[i])
                   for i in range(W))
