"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version: the NTT of either field (``ntt``, ``ntt_bb``), the Poseidon-GL
permutation, leaf sponge and Merkle levels (``poseidon_gl``) and the
Poseidon2-BabyBear ones (``poseidon2_bb``), Keccak-256 rows, Merkle
levels and hash-onion (``keccak``), the device transcript's step and PoW
grind (``transcript``), and the dependent-chain probes of one field or
integer operation (``probes``)."""

from typing import Dict

# set to a list to record each call of a main-path kernel wrapper on the
# card as (its launch counter, *the shape it launched on)
calls = None


def record(counter: str, *shape: int) -> None:
    if calls is not None:
        calls.append((counter, *shape))


def _modules():
    from . import (keccak, ntt, ntt_bb, poseidon2_bb, poseidon_gl, probes,
                   transcript)

    return ntt, ntt_bb, poseidon_gl, poseidon2_bb, keccak, transcript, probes


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for mod in _modules():
        mod.reset_launches()


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    ntt, ntt_bb, poseidon_gl, poseidon2_bb, keccak, transcript, probes = \
        _modules()
    return {"ntt": ntt.launches, "ntt_bb": ntt_bb.launches,
            **poseidon_gl.launches, **poseidon2_bb.launches,
            **keccak.launches, **transcript.launches, **probes.launches}
