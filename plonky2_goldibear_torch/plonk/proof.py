"""Proof containers (reference plonky2/src/plonk/proof.rs:34-428,
fri/proof.rs), with the same field names as the JAX package's
``plonk/proof.py`` so the two proofs compare field by field.

Everything here is host-side data: digests are lists of canonical ints
(a byte hasher's, Keccak's, are ``bytes``), extension values are D-tuples
of ints.

``flatten_proof`` turns a proof into one uint64 array per phase (caps,
openings, FRI caps, final poly, PoW witness, query rounds; a byte digest
as its bytes' values).  It reads only
the field names, so it flattens a proof of either package; the committed
fixtures store the JAX proof in this form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

Ext = Tuple[int, ...]
Digest = List[int]
Cap = List[Digest]


@dataclass
class FriQueryStep:
    evals: List[Ext]
    merkle_proof: List[Digest]


@dataclass
class FriInitialTreeProof:
    # one (leaf values, merkle siblings) pair per oracle
    evals_proofs: List[Tuple[List[int], List[Digest]]]

    def unsalted_eval(self, oracle_index: int, poly_index: int,
                      salted: bool, salt_size: int = 4) -> int:
        """The leaf value of a polynomial; a salted leaf ends in
        ``salt_size`` salt elements (reference fri/proof.rs)."""
        evals = self.evals_proofs[oracle_index][0]
        if salted:
            evals = evals[:len(evals) - salt_size]
        return evals[poly_index]


@dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: List[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_merkle_caps: List[Cap]
    query_round_proofs: List[FriQueryRound]
    final_poly: List[Ext]      # coefficients, low-to-high
    pow_witness: int


@dataclass
class OpeningSet:
    """Purported openings at zeta / g*zeta (reference proof.rs:334-388)."""
    constants: List[Ext]
    plonk_sigmas: List[Ext]
    wires: List[Ext]
    plonk_zs: List[Ext]
    plonk_zs_next: List[Ext]
    partial_products: List[Ext]
    quotient_polys: List[Ext]
    lookup_zs: List[Ext] = field(default_factory=list)
    lookup_zs_next: List[Ext] = field(default_factory=list)

    def to_fri_openings(self) -> List[List[Ext]]:
        """Batches of opened values in FRI order (reference proof.rs:388-428):
        batch 0 at zeta (all polys), batch 1 at g*zeta (Zs + lookups)."""
        zeta_batch = (self.constants + self.plonk_sigmas + self.wires
                      + self.plonk_zs + self.partial_products
                      + self.quotient_polys + self.lookup_zs)
        zeta_next_batch = self.plonk_zs_next + self.lookup_zs_next
        return [zeta_batch, zeta_next_batch]


@dataclass
class Proof:
    wires_cap: Cap
    plonk_zs_partial_products_cap: Cap
    quotient_polys_cap: Cap
    openings: OpeningSet
    opening_proof: FriProof


@dataclass
class ProofWithPublicInputs:
    proof: Proof
    public_inputs: List[int]


# Phases of a proof, in prover order; the keys of ``flatten_proof``.
PROOF_PHASES = ("public_inputs", "wires_cap", "zs_pp_cap", "quotient_cap",
                "openings", "fri_caps", "final_poly", "pow_witness",
                "query_rounds")


def _u64(vals) -> np.ndarray:
    return np.asarray([int(v) for v in vals], dtype=np.uint64)


def _flat(nested) -> List[int]:
    out: List[int] = []

    def walk(x):
        if isinstance(x, (bytes, bytearray)):     # a byte digest
            out.extend(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        else:
            out.append(int(x))

    walk(nested)
    return out


def flatten_proof(pwpi) -> Dict[str, np.ndarray]:
    """One uint64 array per phase of ``PROOF_PHASES``."""
    proof = pwpi.proof
    fri = proof.opening_proof
    queries = []
    for qr in fri.query_round_proofs:
        for leaf, sibs in qr.initial_trees_proof.evals_proofs:
            queries.append(leaf)
            queries.append(sibs)
        for step in qr.steps:
            queries.append(step.evals)
            queries.append(step.merkle_proof)
    return {
        "public_inputs": _u64(pwpi.public_inputs),
        "wires_cap": _u64(_flat(proof.wires_cap)),
        "zs_pp_cap": _u64(_flat(proof.plonk_zs_partial_products_cap)),
        "quotient_cap": _u64(_flat(proof.quotient_polys_cap)),
        "openings": _u64(_flat(proof.openings.to_fri_openings())),
        "fri_caps": _u64(_flat(fri.commit_phase_merkle_caps)),
        "final_poly": _u64(_flat(fri.final_poly)),
        "pow_witness": _u64([fri.pow_witness]),
        "query_rounds": _u64(_flat(queries)),
    }


