"""Poseidon2R0BabyBearGate: width-24 risc0-Poseidon2 permutations in one
row, each with a conditional-swap flag (reference
plonky2/src/gates/poseidon2_risc0_babybear.rs:38-492; the JAX package's
``gates/poseidon2_r0_bb_gate.py``).

Wire layout per op: 49 routed wires (24 inputs, 24 outputs, the swap flag),
then after all ops' routed wires, 197 per op: 8 swap deltas, the 24 S-box
inputs of full rounds 1..3, the 21 partial-round S-box inputs, the 24
S-box inputs of full rounds 4..7.  The constraints re-run the permutation
between the stored S-box inputs (``hash/poseidon2_r0_bb.py``) in the JAX
package's order: the swap bit, the 8 deltas, 72 + 21 + 96 S-box inputs,
24 outputs.  ``eval_unfiltered`` runs over any algebra (the prover's
quotient runs it over ``DeviceBaseAlgebra``); it and
``_Poseidon2R0Generator``, which fills one op's wires on the host, both
run the hash module's one round schedule, ``permute_a``.
"""

from __future__ import annotations

from ..hash import _poseidon2_r0_bb_constants as C
from ..hash import poseidon2_r0_bb as r0
from ..iop import generator as gen
from ..iop import target as tgt
from .base import Gate, HostBaseAlgebra

W = C.SPONGE_WIDTH            # 24
CAP = C.SPONGE_CAPACITY       # 8
HALF = C.HALF_N_FULL_ROUNDS   # 4
NP = C.N_PARTIAL_ROUNDS       # 21
ROUTED_PER_OP = 2 * W + 1
NON_ROUTED_PER_OP = CAP + W * (C.N_FULL_ROUNDS_TOTAL - 1) + NP


class Poseidon2R0BabyBearGate(Gate):
    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @classmethod
    def from_config(cls, config):
        per_op = ROUTED_PER_OP + NON_ROUTED_PER_OP
        return cls(min(config.num_wires // per_op,
                       config.num_routed_wires // ROUTED_PER_OP))

    def id(self):
        return (f"Poseidon2R0BabyBearGate {{ num_ops: {self.num_ops}, "
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

    def _start_full_0(self, op):
        return self._start_delta(op) + CAP

    def wire_full_sbox_0(self, op, round_, i):
        assert 0 < round_ < HALF
        return self._start_full_0(op) + W * (round_ - 1) + i

    def _start_partial(self, op):
        return self._start_full_0(op) + W * (HALF - 1)

    def wire_partial_sbox(self, op, round_):
        return self._start_partial(op) + round_

    def _start_full_1(self, op):
        return self._start_partial(op) + NP

    def wire_full_sbox_1(self, op, round_, i):
        return self._start_full_1(op) + W * round_ + i

    def generators(self, row, local_constants, spec):
        return [_Poseidon2R0Generator(self, row, op, spec)
                for op in range(self.num_ops)]

    def complete_wires(self, builder, gate_idx, slot_idx) -> bool:
        """Route zeros into the unused ops so that their generators, which
        are kept, run (reference poseidon2_risc0_babybear.rs:166-197)."""
        zero = builder.zero()
        completed = slot_idx < self.num_ops
        while slot_idx < self.num_ops:
            builder.connect(zero, tgt.wire(gate_idx, self.wire_swap(slot_idx)))
            for i in range(W):
                builder.connect(zero, tgt.wire(
                    gate_idx, self.wire_input(slot_idx, i)))
            slot_idx += 1
        return completed

    def wire_sbox(self, op, stage, r, i):
        """The wire of an S-box input in ``permute_a``'s terms, or None
        for the first full round's, which is not stored."""
        if stage == 0:
            return self.wire_full_sbox_0(op, r, i) if r else None
        if stage == 1:
            return self.wire_partial_sbox(op, r)
        return self.wire_full_sbox_1(op, r, i)

    def eval_unfiltered(self, A, vars):
        lw = vars.local_wires
        one = A.one()
        constraints = []
        for op in range(self.num_ops):
            swap = lw[self.wire_swap(op)]
            constraints.append(A.mul(swap, A.sub(swap, one)))
            state = [lw[self.wire_input(op, i)] for i in range(W)]
            deltas = [lw[self.wire_delta(op, i)] for i in range(CAP)]
            for i, delta in enumerate(deltas):
                constraints.append(A.sub(A.mul(swap, A.sub(
                    state[i + CAP], state[i])), delta))
            for i, delta in enumerate(deltas):
                state[i], state[i + CAP] = A.add(state[i], delta), \
                    A.sub(state[i + CAP], delta)

            def at_sbox(stage, r, i, x, op=op):
                w = self.wire_sbox(op, stage, r, i)
                if w is None:
                    return x
                constraints.append(A.sub(x, lw[w]))
                return lw[w]

            state = r0.permute_a(A, state, at_sbox)
            constraints += [A.sub(state[i], lw[self.wire_output(op, i)])
                            for i in range(W)]
        return constraints


class _Poseidon2R0Generator(gen.SimpleGenerator):
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
        state = list(wv)
        if swap == 1:
            state[:2 * CAP] = wv[CAP:2 * CAP] + wv[:CAP]

        def at_sbox(stage, r, i, x):
            w = g.wire_sbox(op, stage, r, i)
            if w is not None:
                out.append((tgt.wire(row, w), x))
            return x

        state = r0.permute_a(HostBaseAlgebra(self.spec), state, at_sbox)
        out.extend((tgt.wire(row, g.wire_output(op, i)), state[i])
                   for i in range(W))
