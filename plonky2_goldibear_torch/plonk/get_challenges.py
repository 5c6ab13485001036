"""The Fiat-Shamir challenges of a proof, replayed from the proof alone
(reference plonky2/src/plonk/get_challenges.rs:26-97,
fri/challenges.rs:15-70; the JAX package's ``plonk/get_challenges.py``),
with the port's host challenger.
"""

from __future__ import annotations

from typing import Dict, List

from ..hash.challenger import Challenger
from .proof import ProofWithPublicInputs


def get_challenges(proof_with_pis: ProofWithPublicInputs,
                   public_inputs_hash: List[int], circuit_digest: List[int],
                   common, hasher) -> Dict:
    nch = common.config.num_challenges
    proof = proof_with_pis.proof
    fri = proof.opening_proof

    ch = Challenger(common.spec, hasher)
    ch.observe_hash(circuit_digest)
    ch.observe_hash(public_inputs_hash)
    ch.observe_cap(proof.wires_cap)
    plonk_betas = ch.get_n_challenges(nch)
    plonk_gammas = ch.get_n_challenges(nch)
    # a lookup circuit's deltas: the betas, the gammas, then 2 * nch more
    # (get_challenges.rs:49-76)
    plonk_deltas = []
    if common.num_lookup_polys:
        plonk_deltas = plonk_betas + plonk_gammas + ch.get_n_challenges(
            2 * nch)
    ch.observe_cap(proof.plonk_zs_partial_products_cap)
    plonk_alphas = ch.get_n_challenges(nch)
    ch.observe_cap(proof.quotient_polys_cap)
    plonk_zeta = ch.get_extension_challenge()
    for batch_vals in proof.openings.to_fri_openings():
        ch.observe_extension_elements(batch_vals)

    # FRI (reference fri/challenges.rs:25-70): the PoW witness is observed
    # as one element before the response is drawn
    fri_alpha = ch.get_extension_challenge()
    fri_betas = []
    for cap in fri.commit_phase_merkle_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_extension_challenge())
    ch.observe_extension_elements(fri.final_poly)
    ch.observe_element(fri.pow_witness)
    fri_pow_response = ch.get_challenge()
    fri_query_indices = [
        ch.get_challenge() % common.lde_size
        for _ in range(common.config.fri_config.num_query_rounds)]

    return {
        "plonk_betas": plonk_betas,
        "plonk_gammas": plonk_gammas,
        "plonk_deltas": plonk_deltas,
        "plonk_alphas": plonk_alphas,
        "plonk_zeta": plonk_zeta,
        "fri_alpha": fri_alpha,
        "fri_betas": fri_betas,
        "fri_pow_response": fri_pow_response,
        "fri_query_indices": fri_query_indices,
    }
