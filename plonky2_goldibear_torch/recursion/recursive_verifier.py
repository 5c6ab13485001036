"""The PLONK verifier built into a circuit (reference
plonky2/src/recursion/recursive_verifier.rs, plonk/get_challenges.rs
target side, plonk/vanishing_poly.rs:850-990; the JAX package's
``recursion/recursive_verifier.py``).

``verify_proof`` adds to an outer circuit the whole verification of an
inner proof given as targets (held in the proof's own containers,
``plonk/proof.py``, and ``VerifierOnlyCircuitData``, with a target where
the proof has a value): the hash of its public inputs, the
Fiat-Shamir transcript replayed by a ``RecursiveChallenger``, the
vanishing polynomial at zeta (the inner gates' ``eval_unfiltered`` and
``plonk/vanishing.py:eval_vanishing_poly_a`` over ``CircuitExtAlgebra``),
the quotient identity, and the FRI verifier.  A lookup inner adds its
delta challenges, its lookup polys' openings and each table's polynomial
at delta, evaluated in the circuit (``get_lut_re_evals_circuit``).
``set_proof_with_pis_target`` and ``set_verifier_data_target`` put an
inner proof and its verifier data into a partial witness.
"""

from __future__ import annotations

import dataclasses

from ..field import host
from ..fri import recursive_verifier as fric
from ..gates.base import EvaluationVars
from ..gates.circuit_algebra import CircuitExtAlgebra
from ..gates.lookup_gates import LookupTableGate
from ..plonk import gadgets as gd
from ..plonk import vanishing
from ..plonk.circuit_data import VerifierOnlyCircuitData
from ..plonk.proof import OpeningSet, Proof, ProofWithPublicInputs
from .challenger import RecursiveChallenger


def _virtual_cap(b, cap_height: int):
    return [[b.add_virtual_target()
             for _ in range(b.spec.num_hash_out_elts)]
            for _ in range(1 << cap_height)]


def add_virtual_verifier_data(b, cap_height: int
                              ) -> VerifierOnlyCircuitData:
    return VerifierOnlyCircuitData(
        constants_sigmas_cap=_virtual_cap(b, cap_height),
        circuit_digest=b.add_virtual_targets(b.spec.num_hash_out_elts))


def add_virtual_proof_with_pis(b, common) -> ProofWithPublicInputs:
    """Targets of a proof of a circuit of ``common`` (recursive_verifier.rs:
    142-206); a hiding proof's blinded oracles carry salt leaves
    (``CommonCircuitData.fri_leaf_lens``)."""
    config = common.config
    ext = b.add_virtual_extension_targets
    openings = OpeningSet(
        constants=ext(common.num_constants),
        plonk_sigmas=ext(config.num_routed_wires),
        wires=ext(config.num_wires),
        plonk_zs=ext(config.num_challenges),
        plonk_zs_next=ext(config.num_challenges),
        partial_products=ext(config.num_challenges
                             * common.num_partial_products),
        quotient_polys=ext(common.num_quotient_polys()),
        lookup_zs=ext(common.num_all_lookup_polys()),
        lookup_zs_next=ext(common.num_all_lookup_polys()))
    cap_height = config.fri_config.cap_height
    proof = Proof(
        wires_cap=_virtual_cap(b, cap_height),
        plonk_zs_partial_products_cap=_virtual_cap(b, cap_height),
        quotient_polys_cap=_virtual_cap(b, cap_height),
        openings=openings,
        opening_proof=fric.add_virtual_fri_proof(b, common.fri_leaf_lens(),
                                                 common.fri_params))
    return ProofWithPublicInputs(
        proof=proof,
        public_inputs=b.add_virtual_targets(common.num_public_inputs))


def get_fri_instance_target(b, common, zeta):
    """``common.get_fri_instance`` with the points as extension targets:
    zeta and g * zeta."""
    instance = common.get_fri_instance(host.ext_one(common.spec))
    g = common.spec.two_adic_generator(common.degree_bits)
    instance.batches[0].point = zeta
    instance.batches[1].point = b.mul_const_extension(g, zeta)
    return instance


def get_challenges_target(b, proof_t: Proof, public_inputs_hash,
                          circuit_digest, common) -> dict:
    """The transcript over targets (get_challenges.rs:26-97)."""
    config = common.config
    nch = config.num_challenges
    ch = RecursiveChallenger(b)
    ch.observe_hash(circuit_digest)
    ch.observe_hash(public_inputs_hash)
    ch.observe_cap(proof_t.wires_cap)
    betas = ch.get_n_challenges(nch)
    gammas = ch.get_n_challenges(nch)
    # a lookup inner's deltas (get_challenges.rs:49-76)
    deltas = []
    if common.num_lookup_polys:
        deltas = betas + gammas + ch.get_n_challenges(2 * nch)
    ch.observe_cap(proof_t.plonk_zs_partial_products_cap)
    alphas = ch.get_n_challenges(nch)
    ch.observe_cap(proof_t.quotient_polys_cap)
    zeta = ch.get_extension_challenge()
    ch.observe_openings(proof_t.openings.to_fri_openings())
    fri_alpha = ch.get_extension_challenge()
    fri_betas = []
    for cap in proof_t.opening_proof.commit_phase_merkle_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_extension_challenge())
    ch.observe_extension_elements(proof_t.opening_proof.final_poly)
    ch.observe_element(proof_t.opening_proof.pow_witness)
    fri_pow_response = ch.get_challenge()
    return {
        "plonk_betas": betas, "plonk_gammas": gammas,
        "plonk_deltas": deltas, "plonk_alphas": alphas, "plonk_zeta": zeta,
        "fri_alpha": fri_alpha, "fri_betas": fri_betas,
        "fri_pow_response": fri_pow_response,
        "fri_query_indices": ch.get_n_challenges(
            config.fri_config.num_query_rounds)}


def get_lut_re_evals_circuit(b, common, deltas):
    """Each table's polynomial at a challenge's delta, in the circuit: per
    challenge, per table, Horner over the entries (inp + B * out) at delta,
    then times delta^(padding) by square and multiply (reference
    vanishing_poly.rs:31-52 and its circuit use; the host form is
    ``vanishing.get_lut_re_evals``)."""
    slots = LookupTableGate.num_slots_of(common.config)
    out = []
    for i in range(common.config.num_challenges):
        delta_b, delta_d = deltas[4 * i + 1], deltas[4 * i + 3]
        evals = []
        for lut in common.luts:
            acc = b.zero()
            for inp, out_v in lut:
                acc = b.mul_add(acc, delta_d, b.add_const(
                    b.mul_const(int(out_v), delta_b), int(inp)))
            pad = slots * -(-len(lut) // slots) - len(lut)
            if pad:
                dpow, base, e = None, delta_d, pad
                while e:
                    if e & 1:
                        dpow = base if dpow is None else b.mul(dpow, base)
                    e >>= 1
                    if e:
                        base = b.square(base)
                acc = b.mul(acc, dpow)
            evals.append(acc)
        out.append(evals)
    return out


def eval_l_0_circuit(b, n: int, x, x_pow_n):
    """L_0(x) = (x^n - 1) / (n (x - 1)) in the reference's order
    (plonk_common.rs:75-101): one, the converted neg_one, x^n - 1, then
    the denominator as arithmetic_extension(n, n, x, one, neg_one)."""
    one = b.one_extension()
    neg_one = b.convert_to_ext(b.neg_one())
    eval_zero_poly = b.sub_extension(x_pow_n, one)
    n %= b.spec.p
    denominator = b.arithmetic_extension(n, n, x, one, neg_one)
    return b.div_extension(eval_zero_poly, denominator)


def verify_proof(b, proof_with_pis_t: ProofWithPublicInputs,
                 verifier_data_t: VerifierOnlyCircuitData, common):
    """recursive_verifier.rs:23-140.  The query indices are the raw
    challenges: their low lde_bits bits are the index the host verifier
    takes mod the LDE size (fri/challenges.rs:85-123)."""
    spec = common.spec
    proof_t = proof_with_pis_t.proof
    public_inputs_hash = b.hash_n_to_m_no_pad(
        proof_with_pis_t.public_inputs, spec.num_hash_out_elts)
    challenges = get_challenges_target(
        b, proof_t, public_inputs_hash, verifier_data_t.circuit_digest,
        common)
    zeta = challenges["plonk_zeta"]
    openings = proof_t.openings
    vars = EvaluationVars(openings.constants, openings.wires,
                          [b.convert_to_ext(t) for t in public_inputs_hash])
    # one before anything else (recursive_verifier.rs:66)
    one_ext = b.one_extension()
    zeta_pow_deg = gd.exp_power_of_2_extension(b, zeta, common.degree_bits)
    deltas = challenges["plonk_deltas"]
    lut_re_evals = get_lut_re_evals_circuit(b, common, deltas) \
        if common.num_lookup_polys else []
    vanishing_zeta = vanishing.eval_vanishing_poly_a(
        CircuitExtAlgebra(b), common, zeta,
        # L_0(zeta) is built after the gate constraints
        # (vanishing_poly.rs:902)
        lambda: eval_l_0_circuit(b, common.degree, zeta, zeta_pow_deg),
        vars, openings.plonk_zs, openings.plonk_zs_next,
        openings.partial_products, openings.plonk_sigmas,
        challenges["plonk_betas"], challenges["plonk_gammas"],
        challenges["plonk_alphas"], deltas, openings.lookup_zs,
        openings.lookup_zs_next, lut_re_evals)

    # vanishing_i(zeta) == Z_H(zeta) * (chunk_i reduced by zeta^n), one
    # ReducingFactorTarget for all (recursive_verifier.rs:107-119)
    qdf = common.quotient_degree_factor
    scale = gd.ReducingFactorTarget(zeta_pow_deg)
    z_h_zeta = b.sub_extension(zeta_pow_deg, one_ext)
    for i in range(common.config.num_challenges):
        recombined = scale.reduce(
            list(openings.quotient_polys[i * qdf:(i + 1) * qdf]), b)
        b.connect_extension(vanishing_zeta[i],
                            b.mul_extension(z_h_zeta, recombined))

    fric.verify_fri_proof_circuit(
        b, get_fri_instance_target(b, common, zeta),
        openings.to_fri_openings(), challenges,
        [verifier_data_t.constants_sigmas_cap, proof_t.wires_cap,
         proof_t.plonk_zs_partial_products_cap, proof_t.quotient_polys_cap],
        proof_t.opening_proof, common.fri_params)


# -- witness assignment (iop/witness.rs:76-160, fri/witness_util.rs) --------


def _set_values(pw, targets, values):
    """Each target of ``targets`` set to its value in ``values``, two
    structures of one shape (containers, lists, digests, extension
    elements)."""
    if isinstance(values, (bytes, bytearray)):
        raise ValueError("the inner proof has byte digests (the Keccak "
                         "config): the recursive verifier needs an inner "
                         "proof of an algebraic hasher")
    if dataclasses.is_dataclass(targets):
        for f in dataclasses.fields(targets):
            _set_values(pw, getattr(targets, f.name), getattr(values, f.name))
    elif targets and isinstance(targets[0], str):   # ("w", ...), ("v", i)
        pw.set_target(targets, int(values))
    else:
        if len(targets) != len(values):
            raise ValueError(f"{len(values)} values for {len(targets)} "
                             "targets: the proof is not of the inner "
                             "circuit's shape")
        for t, v in zip(targets, values):
            _set_values(pw, t, v)


def set_proof_with_pis_target(pw, proof_t: ProofWithPublicInputs,
                              proof_with_pis):
    """Raises ``ValueError`` on a proof whose digests are bytes: no gate
    computes Keccak (the reference asks an AlgebraicHasher of the inner
    config)."""
    _set_values(pw, proof_t, proof_with_pis)


def set_verifier_data_target(pw, vk_t: VerifierOnlyCircuitData,
                             verifier_only):
    _set_values(pw, vk_t, verifier_only)
