"""Poseidon2BabyBearGate: width-16 Poseidon2 permutations in one row, each
with a conditional-swap flag (reference
plonky2/src/gates/poseidon2_babybear.rs; the JAX package's
``gates/poseidon2_bb_gate.py``).

Wire layout per op (reference :44-90): 33 routed wires (16 inputs, 16
outputs, the swap flag), then after all ops' routed wires, 133 per op: 8
swap deltas, the 16 S-box inputs of full rounds 1..3, the 13 partial-round
S-box inputs, the 16 S-box inputs of full rounds 4..7.  The constraints
re-run the permutation between the stored S-box inputs, vectorised over
the 16 lanes and every point of the quotient domain, in the JAX package's
order (``eval_unfiltered_device``): the swap bit, the 8 deltas, 48 + 13 +
64 S-box inputs, 16 outputs.  ``_Poseidon2Generator`` fills one op's
wires on the host (``hash/poseidon2_bb.py`` ``*_host``).
"""

from __future__ import annotations

import torch

from ..field import bb
from ..hash import _poseidon2_bb_constants as C
from ..hash import poseidon2_bb as p2
from ..iop import generator as gen
from ..iop import target as tgt
from ..ops import poseidon2_bb as P2
from .base import Gate

W = C.SPONGE_WIDTH            # 16
CAP = C.SPONGE_CAPACITY       # 8
HALF = C.HALF_N_FULL_ROUNDS   # 4
NP = C.N_PARTIAL_ROUNDS       # 13
ROUTED_PER_OP = 2 * W + 1
NON_ROUTED_PER_OP = CAP + W * (C.N_FULL_ROUNDS_TOTAL - 1) + NP


class Poseidon2BabyBearGate(Gate):
    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @classmethod
    def from_config(cls, config):
        per_op = ROUTED_PER_OP + NON_ROUTED_PER_OP
        return cls(min(config.num_wires // per_op,
                       config.num_routed_wires // ROUTED_PER_OP))

    def id(self):
        return (f"Poseidon2BabyBearGate {{ num_ops: {self.num_ops}, "
                f"_phantom: PhantomData<p3_baby_bear::baby_bear::BabyBear> "
                f"}}<WIDTH={W}>")

    def num_wires(self):
        return self.num_ops * (ROUTED_PER_OP + NON_ROUTED_PER_OP)

    def num_constants(self):
        return 0

    def degree(self):
        return 7

    def num_constraints(self):
        return self.num_ops * (1 + CAP + W * (C.N_FULL_ROUNDS_TOTAL - 1)
                               + NP + W)

    # routed wires of op ``op``
    def wire_input(self, op, i):
        return ROUTED_PER_OP * op + i

    def wire_output(self, op, i):
        return ROUTED_PER_OP * op + W + i

    def wire_swap(self, op):
        return ROUTED_PER_OP * op + 2 * W

    # its non-routed wires
    def _start_delta(self, op):
        return self.num_ops * ROUTED_PER_OP + op * NON_ROUTED_PER_OP

    def wire_delta(self, op, i):
        return self._start_delta(op) + i

    def wire_full_sbox_0(self, op, round_, i):
        assert 0 < round_ < HALF
        return self._start_delta(op) + CAP + W * (round_ - 1) + i

    def wire_partial_sbox(self, op, round_):
        return self._start_delta(op) + CAP + W * (HALF - 1) + round_

    def wire_full_sbox_1(self, op, round_, i):
        return self._start_delta(op) + CAP + W * (HALF - 1) + NP \
            + W * round_ + i

    def generators(self, row, local_constants, spec):
        return [_Poseidon2Generator(self, row, op, spec)
                for op in range(self.num_ops)]

    def complete_wires(self, builder, gate_idx, slot_idx) -> bool:
        """Route zeros into the unused ops so that their generators, which
        are kept, run (reference poseidon2_babybear.rs:175-205)."""
        zero = builder.zero()
        completed = slot_idx < self.num_ops
        while slot_idx < self.num_ops:
            builder.connect(zero, tgt.wire(gate_idx, self.wire_swap(slot_idx)))
            for i in range(W):
                builder.connect(zero, tgt.wire(
                    gate_idx, self.wire_input(slot_idx, i)))
            slot_idx += 1
        return completed

    def eval_unfiltered(self, A, vars):
        """The constraints at one point over the algebra ``A``, in the
        order of ``eval_unfiltered_device`` (the JAX package's
        ``gates/poseidon2_bb_gate.py:92``)."""
        lw = vars.local_wires
        one = A.one()
        constraints = []
        for op in range(self.num_ops):
            swap = lw[self.wire_swap(op)]
            constraints.append(A.mul(swap, A.sub(swap, one)))
            inputs = [lw[self.wire_input(op, i)] for i in range(W)]
            deltas = [lw[self.wire_delta(op, i)] for i in range(CAP)]
            # every delta's constraint, then the swapped state: the
            # circuit algebra places its gates in this order
            for i in range(CAP):
                constraints.append(A.sub(A.mul(
                    swap, A.sub(inputs[i + CAP], inputs[i])), deltas[i]))
            state = [None] * W
            for i in range(CAP):
                state[i] = A.add(inputs[i], deltas[i])
                state[i + CAP] = A.sub(inputs[i + CAP], deltas[i])
            state = p2.external_layer_a(A, state)
            for r in range(HALF):
                state = [A.add_base_const(x, c)
                         for x, c in zip(state, C.EXTERNAL_CONSTANTS[r])]
                if r > 0:
                    for i in range(W):
                        sbox_in = lw[self.wire_full_sbox_0(op, r, i)]
                        constraints.append(A.sub(state[i], sbox_in))
                        state[i] = sbox_in
                state = p2.external_layer_a(
                    A, [p2.sbox_a(A, x) for x in state])
            for r in range(NP):
                state[0] = A.add_base_const(state[0],
                                            C.INTERNAL_CONSTANTS[r])
                sbox_in = lw[self.wire_partial_sbox(op, r)]
                constraints.append(A.sub(state[0], sbox_in))
                state[0] = p2.sbox_a(A, sbox_in)
                state = p2.internal_layer_a(A, state)
            for r in range(HALF, C.N_FULL_ROUNDS_TOTAL):
                state = [A.add_base_const(x, c)
                         for x, c in zip(state, C.EXTERNAL_CONSTANTS[r])]
                for i in range(W):
                    sbox_in = lw[self.wire_full_sbox_1(op, r - HALF, i)]
                    constraints.append(A.sub(state[i], sbox_in))
                    state[i] = sbox_in
                state = p2.external_layer_a(
                    A, [p2.sbox_a(A, x) for x in state])
            constraints += [A.sub(state[i], lw[self.wire_output(op, i)])
                            for i in range(W)]
        return constraints

    def eval_unfiltered_device(self, F, wires: torch.Tensor, constants,
                               pi_hash) -> torch.Tensor:
        """Constraints (150 num_ops, m) over stacked BabyBear wires
        (num_wires, m)."""
        assert F is bb, "Poseidon2BabyBearGate is a BabyBear gate"
        ext_rc, int_rc = P2._tables(str(wires.device))
        one = F.ones((), wires.device)
        constraints = []
        for op in range(self.num_ops):
            base = ROUTED_PER_OP * op
            inputs = wires[base:base + W]
            outputs = wires[base + W:base + 2 * W]
            swap = wires[base + 2 * W]
            d0 = self._start_delta(op)
            deltas = wires[d0:d0 + CAP]
            f0 = d0 + CAP
            full0_w = wires[f0:f0 + W * (HALF - 1)].reshape(HALF - 1, W, -1)
            p0 = f0 + W * (HALF - 1)
            partial_w = wires[p0:p0 + NP]
            f1 = p0 + NP
            full1_w = wires[f1:f1 + W * HALF].reshape(HALF, W, -1)

            constraints.append(F.mul(swap, F.sub(swap, one))[None])
            lhs, rhs = inputs[:CAP], inputs[CAP:]
            constraints.append(F.sub(F.mul(swap[None], F.sub(rhs, lhs)),
                                     deltas))

            state = torch.cat([F.add(lhs, deltas), F.sub(rhs, deltas)])
            state = P2.full_round(P2.external_layer(state), 0)
            for r in range(1, HALF):
                constraints.append(F.sub(F.add(state, ext_rc[r]),
                                         full0_w[r - 1]))
                state = P2.external_layer(P2.sbox(full0_w[r - 1]))
            for r in range(NP):
                constraints.append(F.sub(F.add(state[0], int_rc[r]),
                                         partial_w[r])[None])
                state = P2.internal_layer(
                    torch.cat([P2.sbox(partial_w[r])[None], state[1:]]))
            for r in range(HALF):
                constraints.append(F.sub(F.add(state, ext_rc[HALF + r]),
                                         full1_w[r]))
                state = P2.external_layer(P2.sbox(full1_w[r]))
            constraints.append(F.sub(state, outputs))
        out = torch.cat(constraints)
        assert out.shape[0] == self.num_constraints()
        return out


class _Poseidon2Generator(gen.SimpleGenerator):
    """Fills one op's deltas, S-box inputs and outputs."""

    def __init__(self, gate, row, op, spec):
        self.gate, self.row, self.op, self.spec = gate, row, op, spec

    def dependencies(self):
        g, op = self.gate, self.op
        return [tgt.wire(self.row, g.wire_input(op, i)) for i in range(W)] \
            + [tgt.wire(self.row, g.wire_swap(op))]

    def run_once(self, witness, out):
        g, op, row = self.gate, self.op, self.row
        p = self.spec.p
        wv = [witness.get_target(tgt.wire(row, g.wire_input(op, i)))
              for i in range(W)]
        swap = witness.get_target(tgt.wire(row, g.wire_swap(op)))
        assert swap in (0, 1)
        for i in range(CAP):
            out.append((tgt.wire(row, g.wire_delta(op, i)),
                        swap * (wv[i + CAP] - wv[i]) % p))
        state = wv[CAP:] + wv[:CAP] if swap == 1 else list(wv)

        state = p2.external_layer_host(state)
        for r in range(HALF):
            state = [(x + c) % p for x, c in zip(state,
                                                 C.EXTERNAL_CONSTANTS[r])]
            if r > 0:
                out.extend((tgt.wire(row, g.wire_full_sbox_0(op, r, i)),
                            state[i]) for i in range(W))
            state = p2.external_layer_host([p2.sbox_host(x) for x in state])
        for r in range(NP):
            state[0] = (state[0] + C.INTERNAL_CONSTANTS[r]) % p
            out.append((tgt.wire(row, g.wire_partial_sbox(op, r)), state[0]))
            state[0] = p2.sbox_host(state[0])
            state = p2.internal_layer_host(state)
        for r in range(HALF, C.N_FULL_ROUNDS_TOTAL):
            state = [(x + c) % p for x, c in zip(state,
                                                 C.EXTERNAL_CONSTANTS[r])]
            out.extend((tgt.wire(row, g.wire_full_sbox_1(op, r - HALF, i)),
                        state[i]) for i in range(W))
            state = p2.external_layer_host([p2.sbox_host(x) for x in state])
        out.extend((tgt.wire(row, g.wire_output(op, i)), state[i])
                   for i in range(W))
