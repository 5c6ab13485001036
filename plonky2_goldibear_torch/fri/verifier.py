"""The FRI verifier, on the host with python ints (reference
plonky2/src/fri/verifier.rs; the JAX package's ``fri/verifier.py``).

The proof of work, then per query round: the Merkle proofs of the four
initial trees, the combined initial evaluation (salts dropped), each fold
checked against the step's coset and interpolated at the round's beta, each
step's Merkle proof, and the final polynomial at the last point.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field import host
from ..hash import merkle
from ..plonk.proof import FriProof
from .prover import _leading_zeros64, _min_leading_zeros, reduce_openings

Ext = Tuple[int, ...]


class FriVerificationError(Exception):
    pass


def _ensure(cond, msg):
    if not cond:
        raise FriVerificationError(msg)


def compute_evaluation(spec: host.FieldSpec, x: int,
                       x_index_within_coset: int, arity_bits: int,
                       evals: Sequence[Ext], beta: Ext) -> Ext:
    """P'(x^arity) from the values of P on the coset of x, interpolated at
    beta (reference fri/verifier.rs:23-48)."""
    arity = 1 << arity_bits
    assert len(evals) == arity
    p = spec.p
    g = spec.two_adic_generator(arity_bits)
    perm = host.reverse_index_bits_perm(arity_bits)
    evals_nat = [evals[perm[i]] for i in range(arity)]
    rev_x = host.reverse_bits(x_index_within_coset, arity_bits)
    start = x * pow(g, arity - rev_x, p) % p
    points = [start * pow(g, i, p) % p for i in range(arity)]
    return interpolate_ext(spec, points, evals_nat, beta)


def interpolate_ext(spec: host.FieldSpec, xs: Sequence[int],
                    ys: Sequence[Ext], z: Ext) -> Ext:
    """The Lagrange interpolant of base-field points with extension
    values, at the extension point z (O(n^2), n = the FRI arity)."""
    p = spec.p
    result = host.ext_zero(spec)
    for i, xi in enumerate(xs):
        num = host.ext_one(spec)
        den = 1
        for j, xj in enumerate(xs):
            if i != j:
                num = host.ext_mul(spec, num, host.ext_sub(
                    spec, z, host.ext_from_base(spec, xj)))
                den = den * (xi - xj) % p
        li = host.ext_scalar_mul(spec, num, host.finv(den, p))
        result = host.ext_add(spec, result, host.ext_mul(spec, li, ys[i]))
    return result


def fri_verify_proof_of_work(spec, fri_pow_response: int, config):
    _ensure(_leading_zeros64(fri_pow_response)
            >= _min_leading_zeros(config, spec),
            "Invalid proof of work witness.")


def fri_combine_initial(spec, instance, initial_proof, alpha: Ext,
                        subgroup_x: int, precomputed: List[Ext],
                        params) -> Ext:
    """sum over the batches of alpha-shifted (sum_j alpha^j f_j(x) - y_b)
    / (x - z_b), the leaves' salts dropped (reference
    fri/verifier.rs:131-171)."""
    x_ext = host.ext_from_base(spec, subgroup_x)
    s = host.ext_zero(spec)
    for batch, red_open in zip(instance.batches, precomputed):
        evals = [initial_proof.unsalted_eval(
            pi.oracle_index, pi.polynomial_index,
            params.hiding and instance.oracles[pi.oracle_index].blinding)
            for pi in batch.polynomials]
        reduced = reduce_openings(
            spec, [host.ext_from_base(spec, e) for e in evals], alpha)
        quotient = host.ext_div(spec, host.ext_sub(spec, reduced, red_open),
                                host.ext_sub(spec, x_ext, tuple(batch.point)))
        shift = host.ext_pow(spec, alpha, len(evals))
        s = host.ext_add(spec, host.ext_mul(spec, s, shift), quotient)
    return s


def verify_fri_proof(spec, instance, openings: List[List[Ext]], challenges,
                     initial_merkle_caps, proof: FriProof, params, hasher):
    """reference fri/verifier.rs:66-117.  ``openings``: the claimed
    values, one list per batch; ``challenges``: ``get_challenges``'s
    dict."""
    fri_verify_proof_of_work(spec, challenges["fri_pow_response"],
                             params.config)
    _ensure(params.config.num_query_rounds == len(proof.query_round_proofs),
            "Number of query rounds does not match config.")
    alpha = challenges["fri_alpha"]
    precomputed = [reduce_openings(spec, vals, alpha) for vals in openings]
    for x_index, round_proof in zip(challenges["fri_query_indices"],
                                    proof.query_round_proofs):
        _verify_query_round(spec, instance, challenges, precomputed,
                            initial_merkle_caps, proof, x_index, round_proof,
                            params, hasher)


def _verify_query_round(spec, instance, challenges, precomputed,
                        initial_merkle_caps, proof: FriProof, x_index: int,
                        round_proof, params, hasher):
    for (evals, siblings), cap in zip(
            round_proof.initial_trees_proof.evals_proofs,
            initial_merkle_caps):
        _ensure(merkle.verify_merkle_proof_to_cap(evals, x_index, cap,
                                                  siblings, hasher),
                "initial Merkle proof failed")
    p = spec.p
    log_n = params.lde_bits
    subgroup_x = spec.coset_shift * pow(
        spec.two_adic_generator(log_n), host.reverse_bits(x_index, log_n),
        p) % p
    old_eval = fri_combine_initial(spec, instance,
                                   round_proof.initial_trees_proof,
                                   challenges["fri_alpha"], subgroup_x,
                                   precomputed, params)
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        arity = 1 << arity_bits
        step = round_proof.steps[i]
        coset_index = x_index >> arity_bits
        within = x_index & (arity - 1)
        _ensure(tuple(step.evals[within]) == tuple(old_eval),
                "inconsistent fold evaluation")
        old_eval = compute_evaluation(spec, subgroup_x, within, arity_bits,
                                      step.evals, challenges["fri_betas"][i])
        _ensure(merkle.verify_merkle_proof_to_cap(
            [c for e in step.evals for c in e], coset_index,
            proof.commit_phase_merkle_caps[i], step.merkle_proof, hasher),
            "commit-phase Merkle proof failed")
        subgroup_x = pow(subgroup_x, arity, p)
        x_index = coset_index
    # the final polynomial, coefficients low to high, at the last point
    acc = host.ext_zero(spec)
    x_ext = host.ext_from_base(spec, subgroup_x)
    for c in reversed(proof.final_poly):
        acc = host.ext_add(spec, host.ext_mul(spec, acc, x_ext), tuple(c))
    _ensure(tuple(acc) == tuple(old_eval),
            "Final polynomial evaluation is invalid.")
