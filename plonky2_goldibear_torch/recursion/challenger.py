"""The Fiat-Shamir challenger over targets (reference
plonky2/src/iop/challenger.rs:160-305; the JAX package's
``recursion/challenger.py``).

The host challenger (``hash/challenger.py``) duplexes as soon as RATE
inputs are buffered; this one buffers every input and absorbs it RATE at
a time when a challenge is drawn.  Both give the same transcript
(overwrite-mode absorption in chunks), and this one places a permutation
gate per absorbed chunk, as the reference's does.
"""

from __future__ import annotations

from typing import List, Sequence


class RecursiveChallenger:
    def __init__(self, builder):
        self.b = builder
        # the inner proof's transcript: the builder's algebraic hasher
        self.hasher = builder.inner_hasher
        self.sponge_state: List = [builder.zero()] * self.hasher.WIDTH
        self.input_buffer: List = []
        self.output_buffer: List = []

    def observe_element(self, t):
        self.output_buffer.clear()
        self.input_buffer.append(t)

    def observe_elements(self, ts: Sequence):
        for t in ts:
            self.observe_element(t)

    def observe_hash(self, hash_targets: Sequence):
        self.observe_elements(list(hash_targets))

    def observe_cap(self, cap: Sequence):
        for h in cap:
            self.observe_hash(h)

    def observe_extension_element(self, e):
        self.observe_elements(list(e))

    def observe_extension_elements(self, es: Sequence):
        for e in es:
            self.observe_extension_element(e)

    def observe_openings(self, openings_batches: Sequence):
        for batch in openings_batches:
            self.observe_extension_elements(batch)

    def get_challenge(self):
        self._absorb_buffered_inputs()
        if not self.output_buffer:
            self.sponge_state = self.b.permute(self.sponge_state)
            self.output_buffer = list(self.sponge_state[:self.hasher.RATE])
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> tuple:
        return tuple(self.get_n_challenges(self.b.spec.ext_degree))

    def _absorb_buffered_inputs(self):
        if not self.input_buffer:
            return
        rate = self.hasher.RATE
        for i in range(0, len(self.input_buffer), rate):
            chunk = self.input_buffer[i:i + rate]
            self.sponge_state = self.b.permute(
                chunk + self.sponge_state[len(chunk):])
        self.output_buffer = list(self.sponge_state[:rate])
        self.input_buffer.clear()
