"""Device-resident Fiat-Shamir transcript (the JAX package's
``hash/device_challenger.py``): an element-exact twin of the host
:class:`hash.challenger.Challenger` (reference iop/challenger.rs:18-160)
whose sponge state, output buffer and challenges stay on the device.

What the transcript has absorbed is tracked on the host as lengths only:
``observe_*`` appends a device tensor to a pending list; the next challenge
request replays the host's duplex schedule over the pending pieces in one
``ops/transcript.py:transcript_flush`` (one launch on the card): overwrite
state[0..RATE] and permute at each full chunk, squeeze from the END of the
output buffer.  Nothing is read back, so the prover never waits on the
card between phases.  Driven with the same observations and squeezes, it
gives the host challenger's challenges bit for bit
(``tests/test_torch_device_challenger.py``).  Poseidon-GL and
Poseidon2-BB only: a byte-digest hasher (Keccak) keeps the host
transcript.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import transcript as T


class DeviceChallenger:
    def __init__(self, F, hasher, device):
        self.F = F
        self.hasher = hasher
        self.R = hasher.RATE
        self.W = hasher.WIDTH
        self.state = F.zeros((self.W,), device)
        self.out_buf = F.zeros((self.R,), device)
        self.n_out = 0                    # outputs left, known statically
        self.pending: List[torch.Tensor] = []   # 1-D pieces to absorb
        self.pending_lens: List[int] = []

    # -- observations (nothing runs) -----------------------------------------

    def observe_array(self, arr: torch.Tensor):
        """Absorb a flat device tensor of field elements."""
        if arr.shape[0]:
            self.pending.append(arr)
            self.pending_lens.append(arr.shape[0])

    def observe_cap(self, cap: torch.Tensor):
        """A Merkle cap (cap_size, digest) in digest order."""
        self.observe_array(cap.reshape(-1))

    def observe_host_ints(self, values: Sequence[int]):
        self.observe_array(self.F.from_ints([int(v) for v in values],
                                            self.state.device))

    def observe_ext_flat(self, comps: Sequence[torch.Tensor]):
        """Extension elements given as D component tensors (n,), absorbed
        element by element, component-minor."""
        self.observe_array(flat_ext(comps))

    # -- challenges (one step) -----------------------------------------------

    def get_n_challenges(self, n: int) -> torch.Tensor:
        """A device (n,) tensor of challenges; with n = 0, the leftover
        inputs (fewer than RATE), which the step leaves unabsorbed."""
        dst = T.transcript_flush(self.state, self.out_buf, self.pending,
                                 self.n_out, n)
        self.state = dst[:self.W]
        self.out_buf = dst[self.W:self.W + self.R]
        _, self.n_out = T.flush_schedule(sum(self.pending_lens),
                                         self.n_out, n)
        self.pending, self.pending_lens = [], []
        return dst[self.W + self.R:]

    def get_challenge_scalar(self) -> torch.Tensor:
        return self.get_n_challenges(1)[0]

    def get_extension_challenge(self, D: int) -> Tuple[torch.Tensor, ...]:
        return tuple(self.get_n_challenges(D).unbind(0))

    # -- the PoW grind's input -----------------------------------------------

    def grind_inputs(self) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                    int]:
        """(sponge state, leftover inputs or None, their number L): what the
        FRI PoW grinder overlays and puts the candidate after (reference
        fri/prover.rs:136-188).  Full chunks pending are absorbed first."""
        if sum(self.pending_lens) >= self.R:
            self.observe_array(self.get_n_challenges(0))
        if len(self.pending) > 1:
            self.pending = [torch.cat(self.pending)]
            self.pending_lens = [sum(self.pending_lens)]
        L = self.pending_lens[0] if self.pending_lens else 0
        return self.state, (self.pending[0] if L else None), L


def flat_ext(comps: Sequence[torch.Tensor]) -> torch.Tensor:
    """D component tensors (n,) -> (n * D,), element by element (the order
    the host challenger observes extension elements in)."""
    return torch.stack(list(comps), dim=1).reshape(-1)
