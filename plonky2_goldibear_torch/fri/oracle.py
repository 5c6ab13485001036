"""Polynomial-batch commitment: iFFT -> coset LDE -> Merkle tree with cap.

The reference's ``PolynomialBatch`` (plonky2/src/fri/oracle.rs:29-184):
low-degree-extend each polynomial onto the coset ``shift * <g>`` at rate
2^rate_bits, transpose to per-point leaf rows, bit-reverse the leaf order
and Merkle-hash with a cap.  Polynomials are (num_polys, n) tensors of
the field module ``F``, hashed with ``hasher`` (Goldilocks and Poseidon-GL
by default).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..field import fft as fftm
from ..field import gl
from ..hash import merkle, poseidon_gl


def lde_values(coeffs: torch.Tensor, rate_bits: int, F=gl) -> torch.Tensor:
    """Coset LDE (num_polys, n) -> (num_polys, n << rate_bits)."""
    return fftm.lde_coset_fft(coeffs, rate_bits, F)


def leaves_from_lde(lde: torch.Tensor) -> torch.Tensor:
    """LDE values (num_polys, m) -> leaf rows (m, num_polys) in bit-reversed
    point order (reference fri/oracle.rs:110-121)."""
    return fftm.reverse_index_bits(lde.t(), dim=0).contiguous()


def commit_coeffs(coeffs: torch.Tensor, rate_bits: int, cap_height: int,
                  F=gl, hasher=poseidon_gl
                  ) -> Tuple[torch.Tensor, merkle.MerkleTree]:
    """Coefficient batch -> (natural-order LDE, Merkle tree of its leaves)."""
    lde = lde_values(coeffs, rate_bits, F)
    return lde, merkle.MerkleTree(leaves_from_lde(lde), cap_height, hasher)


class PolynomialBatch:
    """Committed batch of polynomials (the FRI oracle): coefficients for the
    openings, the natural-order LDE for the quotient and FRI combine, and
    the Merkle tree over the bit-reversed leaf rows."""

    def __init__(self, coeffs: torch.Tensor, rate_bits: int, cap_height: int,
                 F=gl, hasher=poseidon_gl):
        self.coeffs = coeffs
        self.lde, self.tree = commit_coeffs(coeffs, rate_bits, cap_height,
                                            F, hasher)

    @classmethod
    def from_values(cls, values: torch.Tensor, rate_bits: int,
                    cap_height: int, F=gl, hasher=poseidon_gl):
        """Values on the 2-adic subgroup -> iFFT -> commit (reference
        fri/oracle.rs:68-91)."""
        return cls(fftm.ifft(values, F), rate_bits, cap_height, F, hasher)

    def cap_host(self) -> List[List[int]]:
        return self.tree.cap_host()
