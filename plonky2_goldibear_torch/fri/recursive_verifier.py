"""The FRI verifier built into a circuit (reference
plonky2/src/fri/recursive_verifier.rs; the JAX package's
``fri/recursive_verifier.py``).

``fri/verifier.py`` over targets: per query round, the initial Merkle
openings checked against their caps at the query's cap index, combined
with alpha; then per fold step the claimed evaluation picked by a
RandomAccessGate, the next one interpolated at beta by a
CosetInterpolationGate, the step's Merkle opening checked; last the final
polynomial at the folded point.
"""

from __future__ import annotations

from typing import List

from ..field import host
from ..gates.coset_interpolation import CosetInterpolationGate
from ..plonk import gadgets as gd
from ..plonk.proof import (FriInitialTreeProof, FriProof, FriQueryRound,
                           FriQueryStep)


def _virtual_digests(b, n: int) -> List[List]:
    return [[b.add_virtual_target()
             for _ in range(b.spec.num_hash_out_elts)] for _ in range(n)]


def add_virtual_fri_proof(b, num_leaves_per_oracle: List[int],
                          params) -> FriProof:
    """Targets of a FRI proof, in ``plonk/proof.py``'s containers
    (recursive_verifier.rs:397-425)."""
    cap_height = params.config.cap_height
    caps = [_virtual_digests(b, 1 << cap_height)
            for _ in params.reduction_arity_bits]
    rounds = []
    for _ in range(params.config.num_query_rounds):
        evals_proofs = [
            ([b.add_virtual_target() for _ in range(n_leaves)],
             _virtual_digests(b, params.lde_bits - cap_height))
            for n_leaves in num_leaves_per_oracle]
        steps = []
        codeword_bits = params.lde_bits
        for arity_bits in params.reduction_arity_bits:
            codeword_bits -= arity_bits
            evals = b.add_virtual_extension_targets(1 << arity_bits)
            steps.append(FriQueryStep(
                evals=evals,
                merkle_proof=_virtual_digests(b, codeword_bits - cap_height)))
        rounds.append(FriQueryRound(FriInitialTreeProof(evals_proofs),
                                    steps))
    final_poly = b.add_virtual_extension_targets(params.final_poly_len)
    return FriProof(commit_phase_merkle_caps=caps, query_round_proofs=rounds,
                    final_poly=final_poly, pow_witness=b.add_virtual_target())


def _compute_evaluation(b, x, x_index_within_coset_bits, arity_bits,
                        evals, beta):
    """The fold of one coset at beta (recursive_verifier.rs:30-58): the
    evaluations in natural order, interpolated on the coset x g^-rev(i)
    <g>."""
    spec = b.spec
    arity = 1 << arity_bits
    assert len(evals) == arity
    g_inv = pow(spec.two_adic_generator(arity_bits), arity - 1, spec.p)
    perm = host.reverse_index_bits_perm(arity_bits)
    evals_nat = [evals[perm[i]] for i in range(arity)]
    # g^(arity - rev(i)) = (g^-1)^rev(i): the reversed bits into the
    # little-endian exponent gadget (recursive_verifier.rs:49)
    start = gd.exp_from_bits_const_base(
        b, g_inv, list(reversed(x_index_within_coset_bits)))
    coset_start = b.mul(start, x)
    gate = CosetInterpolationGate.with_max_degree(
        arity_bits, b.config.max_quotient_degree_factor, spec)
    return gd.interpolate_coset(b, gate, coset_start, evals_nat, beta)


def fri_combine_initial_circuit(b, instance, initial_proof, alpha,
                                subgroup_x, reduced_openings, params):
    """recursive_verifier.rs:211-250: per batch, (reduced leaf values -
    reduced openings) / (x - point), the batches summed by alpha powers."""
    subgroup_x_ext = b.convert_to_ext(subgroup_x)
    red = gd.ReducingFactorTarget(alpha)
    total = b.zero_extension()
    for batch, red_open in zip(instance.batches, reduced_openings):
        evals = [initial_proof.unsalted_eval(
            pinfo.oracle_index, pinfo.polynomial_index,
            params.hiding and instance.oracles[pinfo.oracle_index].blinding)
            for pinfo in batch.polynomials]
        numerator = b.sub_extension(red.reduce_base(evals, b), red_open)
        denominator = b.sub_extension(subgroup_x_ext, batch.point)
        total = red.shift(total, b)
        # x / y + z in one gadget (recursive_verifier.rs:248)
        total = b.div_add_extension(numerator, denominator, total)
    return total


def verify_fri_proof_circuit(b, instance, openings_batches, challenges,
                             initial_merkle_caps, proof: FriProof,
                             params):
    """recursive_verifier.rs:104-175."""
    assert params.final_poly_len == len(proof.final_poly)
    assert params.config.num_query_rounds == len(proof.query_round_proofs)
    gd.assert_leading_zeros(
        b, challenges["fri_pow_response"],
        params.config.proof_of_work_bits + (64 - b.spec.bits))
    reduced_openings = [
        gd.ReducingFactorTarget(challenges["fri_alpha"]).reduce(vals, b)
        for vals in openings_batches]
    for x_index, round_proof in zip(challenges["fri_query_indices"],
                                    proof.query_round_proofs):
        _verifier_query_round(b, instance, challenges, reduced_openings,
                              initial_merkle_caps, proof, x_index,
                              round_proof, params)


def _verifier_query_round(b, instance, challenges, reduced_openings,
                          initial_merkle_caps, proof, x_index, round_proof,
                          params):
    """recursive_verifier.rs:252-372.  The index is the raw challenge; its
    low lde_bits bits, from a 64-bit decomposition that admits x + p, are
    the query (recursive_verifier.rs:375-392 on why that is sound)."""
    spec = b.spec
    x_index_bits = gd.low_bits(b, x_index, params.lde_bits, True, spec.bits)
    cap_index = gd.le_sum(
        b, x_index_bits[len(x_index_bits) - params.config.cap_height:])
    for (evals, mproof), cap in zip(
            round_proof.initial_trees_proof.evals_proofs,
            initial_merkle_caps):
        gd.verify_merkle_proof_to_cap_with_cap_index(
            b, list(evals), x_index_bits, cap_index, cap, mproof)

    # subgroup_x = g_F * phi^rev(x_index) (recursive_verifier.rs:296-300)
    phi_pow = gd.exp_from_bits_const_base(
        b, spec.two_adic_generator(params.lde_bits),
        list(reversed(x_index_bits)))
    subgroup_x = b.mul(b.constant(spec.coset_shift), phi_pow)

    old_eval = fri_combine_initial_circuit(
        b, instance, round_proof.initial_trees_proof,
        challenges["fri_alpha"], subgroup_x, reduced_openings, params)
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        evals = round_proof.steps[i].evals
        coset_index_bits = x_index_bits[arity_bits:]
        x_index_within_coset_bits = x_index_bits[:arity_bits]
        x_index_within_coset = gd.le_sum(b, x_index_within_coset_bits)
        b.connect_extension(
            gd.random_access_extension(b, x_index_within_coset, list(evals)),
            old_eval)
        old_eval = _compute_evaluation(
            b, subgroup_x, x_index_within_coset_bits, arity_bits, evals,
            challenges["fri_betas"][i])
        gd.verify_merkle_proof_to_cap_with_cap_index(
            b, [c for e in evals for c in e], coset_index_bits, cap_index,
            proof.commit_phase_merkle_caps[i],
            round_proof.steps[i].merkle_proof)
        subgroup_x = gd.exp_power_of_2(b, subgroup_x, arity_bits)
        x_index_bits = coset_index_bits

    # the final polynomial at subgroup_x by Horner (recursive_verifier.rs:
    # 363-372, polynomial.rs:24-33)
    red = gd.ReducingFactorTarget(b.convert_to_ext(subgroup_x))
    b.connect_extension(red.reduce(list(proof.final_poly), b), old_eval)
