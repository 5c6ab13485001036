"""Fiat-Shamir challenger: duplex sponge in overwrite mode, on the host.

Element-exact port of the reference semantics
(plonky2/src/iop/challenger.rs:18-160):

- ``observe_element`` clears any buffered outputs, pushes to the input
  buffer, and duplexes when the buffer reaches RATE.
- ``get_challenge`` duplexes if inputs are pending or outputs are exhausted,
  then pops from the END of the squeezed RATE-element buffer.
- ``duplexing`` overwrites state[0..len(inputs)] with the buffered inputs,
  permutes, and refills the output buffer with state[0..RATE].

The transcript is tiny and sequential, so it runs on the host between the
device phases, as in the reference.  It works on canonical ints with the
hasher's host permutation: Poseidon-GL (width 12, rate 8), Poseidon2-BB
(width 16, rate 8) or Keccak's hash-onion (width 12, rate 8), whose byte
digests are observed as 7-byte little-endian chunks.
"""

from __future__ import annotations

from typing import List, Sequence

from ..field import host
from . import keccak_hasher, poseidon_gl


class Challenger:
    def __init__(self, spec: host.FieldSpec = host.GOLDILOCKS,
                 hasher=poseidon_gl):
        self.permute = hasher.permute_host
        self.width = hasher.WIDTH
        self.rate = hasher.RATE
        self.spec = spec
        self.sponge_state: List[int] = [0] * self.width
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    def observe_element(self, element: int):
        assert 0 <= element < self.spec.p
        self.output_buffer.clear()
        self.input_buffer.append(element)
        if len(self.input_buffer) == self.rate:
            self._duplexing()

    def observe_elements(self, elements: Sequence[int]):
        for e in elements:
            self.observe_element(int(e))

    def observe_extension_elements(self, elements: Sequence[Sequence[int]]):
        for e in elements:
            self.observe_elements(list(e))

    def observe_hash(self, digest):
        """A digest: its field elements, or a byte digest's 7-byte
        little-endian chunks (reference hash_types.rs:259-286,
        GenericHashOut::to_vec)."""
        if isinstance(digest, bytes):
            digest = keccak_hasher.digest_to_elements(digest)
        self.observe_elements(list(digest))

    def observe_cap(self, cap: Sequence[Sequence[int]]):
        for h in cap:
            self.observe_hash(h)

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> tuple:
        return tuple(self.get_n_challenges(self.spec.ext_degree))

    def _duplexing(self):
        assert len(self.input_buffer) <= self.rate
        for i, x in enumerate(self.input_buffer):
            self.sponge_state[i] = x
        self.input_buffer.clear()
        self.sponge_state = self.permute(self.sponge_state)
        self.output_buffer = list(self.sponge_state[:self.rate])
