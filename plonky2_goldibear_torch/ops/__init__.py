"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version: the Goldilocks NTT (``ntt``) and the Poseidon-GL permutation, leaf
sponge and Merkle levels (``poseidon_gl``)."""

from typing import Dict


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from . import ntt, poseidon_gl

    ntt.reset_launches()
    poseidon_gl.reset_launches()


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    from . import ntt, poseidon_gl

    return {"ntt": ntt.launches, **poseidon_gl.launches}
