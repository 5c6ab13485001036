"""The proof verifier, on the host with exact python-int arithmetic
(reference plonky2/src/plonk/verifier.rs:17-129; the JAX package's
``plonk/verifier.py``).  It launches no kernel: the shape check, the
challenge replay, the vanishing polynomial at zeta against Z_H(zeta) times
the quotient chunks, then the FRI verifier.

    verify(proof_with_pis, verifier_data, common)   # raises on failure

``CircuitData.verify`` calls it with the circuit's data and hashers;
``plonk/serialization.py`` reads the three inputs from bytes.
"""

from __future__ import annotations

from ..field import host
from ..fri import verifier as fri_verifier
from ..gates.base import EvaluationVars, HostExtAlgebra
from ..hash import keccak_hasher
from . import vanishing
from .circuit_data import hasher_of
from .get_challenges import get_challenges
from .proof import ProofWithPublicInputs
from .validate_shape import ShapeError, validate_proof_with_pis_shape


class VerificationError(Exception):
    pass


def verify(proof_with_pis: ProofWithPublicInputs, verifier_data, common,
           hasher=None, inner_hasher=None) -> None:
    """Raise ``VerificationError`` unless the proof is valid.  ``hasher``
    checks the Merkle trees and runs the transcript, ``inner_hasher``
    hashes the public inputs (reference verifier.rs:54); both default to
    the field's own, but a byte circuit digest in ``verifier_data`` makes
    ``hasher`` default to Keccak, the only byte hasher."""
    spec = common.spec
    inner_hasher = inner_hasher or hasher_of(spec)
    if hasher is None:
        hasher = keccak_hasher if isinstance(verifier_data.circuit_digest,
                                             bytes) else inner_hasher
    proof = proof_with_pis.proof
    try:
        validate_proof_with_pis_shape(proof_with_pis, common, hasher)
    except ShapeError as e:
        raise VerificationError(str(e)) from None

    public_inputs_hash = inner_hasher.hash_no_pad_host(
        proof_with_pis.public_inputs)
    challenges = get_challenges(proof_with_pis, public_inputs_hash,
                                verifier_data.circuit_digest, common, hasher)

    A = HostExtAlgebra(spec)
    o = proof.openings
    vars = EvaluationVars(o.constants, o.wires,
                          [A.from_int(x) for x in public_inputs_hash])
    zeta = challenges["plonk_zeta"]
    zeta_pow_deg = host.ext_pow(spec, zeta, common.degree)
    l_0_zeta = vanishing.eval_l_0_host(A, common.degree, zeta, zeta_pow_deg)
    vanishing_polys_zeta = vanishing.eval_vanishing_poly_a(
        A, common, zeta, l_0_zeta, vars, o.plonk_zs, o.plonk_zs_next,
        o.partial_products, o.plonk_sigmas, challenges["plonk_betas"],
        challenges["plonk_gammas"], challenges["plonk_alphas"],
        challenges["plonk_deltas"], o.lookup_zs, o.lookup_zs_next,
        vanishing.get_lut_re_evals(common, challenges["plonk_deltas"])
        if common.num_lookup_polys else [])

    # t(zeta) from its chunks: sum_k chunk_k zeta^(n k)
    # (reference verifier.rs:93-113)
    z_h_zeta = host.ext_sub(spec, zeta_pow_deg, host.ext_one(spec))
    qdf = common.quotient_degree_factor
    for i, lhs in enumerate(vanishing_polys_zeta):
        chunk = o.quotient_polys[i * qdf:(i + 1) * qdf]
        acc = host.ext_zero(spec)
        for term in reversed(chunk):
            acc = host.ext_add(spec, host.ext_mul(spec, acc, zeta_pow_deg),
                               tuple(term))
        if tuple(lhs) != host.ext_mul(spec, z_h_zeta, acc):
            raise VerificationError(
                f"vanishing != Z_H * quotient for challenge {i}")

    caps = [verifier_data.constants_sigmas_cap, proof.wires_cap,
            proof.plonk_zs_partial_products_cap, proof.quotient_polys_cap]
    try:
        fri_verifier.verify_fri_proof(
            spec, common.get_fri_instance(zeta), o.to_fri_openings(),
            challenges, caps, proof.opening_proof, common.fri_params, hasher)
    except fri_verifier.FriVerificationError as e:
        raise VerificationError(str(e)) from e
