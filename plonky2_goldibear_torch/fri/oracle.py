"""Polynomial-batch commitment: iFFT -> coset LDE -> Merkle tree with cap.

The reference's ``PolynomialBatch`` (plonky2/src/fri/oracle.rs:29-184):
low-degree-extend each polynomial onto the coset ``shift * <g>`` at rate
2^rate_bits, transpose to per-point leaf rows, bit-reverse the leaf order
and Merkle-hash with a cap.  Polynomials are (num_polys, n) tensors of
the field module ``F``, hashed with ``hasher`` (Goldilocks and Poseidon-GL
by default).

A blinded batch (a zero-knowledge proof's wires, Z/partial-product and
quotient oracles) salts its leaves: ``SALT_SIZE`` rows of random values on
the LDE coset, drawn from the prover's rng per row and then per point
(reference fri/oracle.rs:139-149), follow the LDE rows into the leaves, so
the sponge hashes ``num_polys + 4`` elements a leaf.  The LDE the prover
reads (quotient, FRI combine) stays unsalted.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..field import fft as fftm
from ..field import gl
from ..hash import merkle, poseidon_gl
from ..iop.generator import Rng, rand_field_elements

# salt rows of a blinded batch (reference fri/oracle.rs:25)
SALT_SIZE = 4


def lde_values(coeffs: torch.Tensor, rate_bits: int, F=gl) -> torch.Tensor:
    """Coset LDE (num_polys, n) -> (num_polys, n << rate_bits)."""
    return fftm.lde_coset_fft(coeffs, rate_bits, F)


def leaves_from_lde(lde: torch.Tensor) -> torch.Tensor:
    """LDE values (num_polys, m) -> leaf rows (m, num_polys) in bit-reversed
    point order (reference fri/oracle.rs:110-121)."""
    return fftm.reverse_index_bits(lde.t(), dim=0).contiguous()


def random_salt(m: int, F, rng: Rng, device) -> torch.Tensor:
    """(SALT_SIZE, m) random field values, row by row."""
    vals = rand_field_elements(F.P, rng, SALT_SIZE * m)
    return F.from_ints(vals.reshape(SALT_SIZE, m), device)


def commit_coeffs(coeffs: torch.Tensor, rate_bits: int, cap_height: int,
                  F=gl, hasher=poseidon_gl, salt_rng: Optional[Rng] = None
                  ) -> Tuple[torch.Tensor, merkle.MerkleTree]:
    """Coefficient batch -> (natural-order LDE, Merkle tree of its leaves,
    salted from ``salt_rng`` when one is given)."""
    lde = lde_values(coeffs, rate_bits, F)
    rows = lde
    if salt_rng is not None:
        rows = torch.cat([lde, random_salt(lde.shape[-1], F, salt_rng,
                                           lde.device)])
    return lde, merkle.MerkleTree(leaves_from_lde(rows), cap_height, hasher)


class PolynomialBatch:
    """Committed batch of polynomials (the FRI oracle): coefficients for the
    openings, the natural-order LDE for the quotient and FRI combine, and
    the Merkle tree over the bit-reversed leaf rows, salted from
    ``salt_rng`` when one is given (a blinded oracle)."""

    def __init__(self, coeffs: torch.Tensor, rate_bits: int, cap_height: int,
                 F=gl, hasher=poseidon_gl, salt_rng: Optional[Rng] = None):
        self.coeffs = coeffs
        self.lde, self.tree = commit_coeffs(coeffs, rate_bits, cap_height,
                                            F, hasher, salt_rng)

    @classmethod
    def from_values(cls, values: torch.Tensor, rate_bits: int,
                    cap_height: int, F=gl, hasher=poseidon_gl,
                    salt_rng: Optional[Rng] = None):
        """Values on the 2-adic subgroup -> iFFT -> commit (reference
        fri/oracle.rs:68-91)."""
        return cls(fftm.ifft(values, F), rate_bits, cap_height, F, hasher,
                   salt_rng)

    def cap_host(self) -> List[List[int]]:
        return self.tree.cap_host()
