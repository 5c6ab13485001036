"""The shape of a proof, checked before it is verified (reference
plonky2/src/plonk/validate_shape.rs:10-72, fri/validate_shape.rs; the JAX
package's ``plonk/validate_shape.py``): a malformed proof (wrong list
lengths, truncated FRI rounds, wrong extension degree) fails with a clean
``ShapeError`` instead of an IndexError part way through.
"""

from __future__ import annotations


class ShapeError(Exception):
    pass


def _check(cond: bool, what: str):
    if not cond:
        raise ShapeError(f"malformed proof: {what}")


def _digest_shape(common, hasher):
    """(digest type, its length) of a cap entry or a Merkle sibling: the
    bytes of a byte hasher (Keccak), else the field's elements."""
    if getattr(hasher, "DIGEST_IS_BYTES", False):
        return bytes, hasher.HASH_SIZE
    return None, common.spec.num_hash_out_elts


def _check_digests(digests, shape, what: str):
    kind, length = shape
    for d in digests:
        _check((kind is None or isinstance(d, kind)) and len(d) == length,
               f"{what}: digest type or width")


def _check_cap(cap, cap_height: int, shape, what: str):
    _check(len(cap) == 1 << cap_height, f"{what}: cap length")
    _check_digests(cap, shape, what)


def _check_exts(vals, n: int, degree: int, what: str):
    _check(len(vals) == n, f"{what}: count {len(vals)} != {n}")
    for v in vals:
        _check(len(v) == degree, f"{what}: extension degree")


def validate_proof_with_pis_shape(proof_with_pis, common,
                                  hasher=None) -> None:
    """``hasher``: the Merkle hasher (None: the field's own)."""
    config = common.config
    d = common.spec.ext_degree
    h = _digest_shape(common, hasher)
    cap_height = config.fri_config.cap_height
    proof = proof_with_pis.proof

    _check(len(proof_with_pis.public_inputs) == common.num_public_inputs,
           "public input count")
    _check_cap(proof.wires_cap, cap_height, h, "wires cap")
    _check_cap(proof.plonk_zs_partial_products_cap, cap_height, h,
               "zs/partial products cap")
    _check_cap(proof.quotient_polys_cap, cap_height, h, "quotient cap")

    o = proof.openings
    nch = config.num_challenges
    for vals, n, what in (
            (o.constants, common.num_constants, "constants"),
            (o.plonk_sigmas, config.num_routed_wires, "sigma"),
            (o.wires, config.num_wires, "wire"),
            (o.plonk_zs, nch, "Z"),
            (o.plonk_zs_next, nch, "Z next"),
            (o.partial_products, nch * common.num_partial_products,
             "partial product"),
            (o.quotient_polys, common.num_quotient_polys(), "quotient"),
            (o.lookup_zs, common.num_all_lookup_polys(), "lookup Z"),
            (o.lookup_zs_next, common.num_all_lookup_polys(),
             "lookup Z next")):
        _check_exts(vals, n, d, f"{what} openings")

    validate_fri_proof_shape(proof.opening_proof, common, hasher)


def validate_fri_proof_shape(fri_proof, common, hasher=None) -> None:
    d = common.spec.ext_degree
    h = _digest_shape(common, hasher)
    params = common.fri_params
    config = params.config
    cap_height = config.cap_height

    _check(len(fri_proof.commit_phase_merkle_caps)
           == len(params.reduction_arity_bits), "FRI commit caps count")
    for cap in fri_proof.commit_phase_merkle_caps:
        _check_cap(cap, cap_height, h, "FRI commit cap")

    _check(len(fri_proof.query_round_proofs) == config.num_query_rounds,
           "FRI query round count")
    leaf_lens = common.fri_leaf_lens()
    for qr in fri_proof.query_round_proofs:
        init = qr.initial_trees_proof.evals_proofs
        _check(len(init) == len(leaf_lens), "initial tree proof count")
        for ep, leaf_len in zip(init, leaf_lens):
            _check(len(ep) == 2, "initial tree proof pair")
            _check(len(ep[0]) == leaf_len, "initial tree evals length")
            _check(len(ep[1]) == params.lde_bits - cap_height,
                   "initial tree merkle path length")
            _check_digests(ep[1], h, "initial tree merkle path")
        _check(len(qr.steps) == len(params.reduction_arity_bits),
               "FRI step count")
        codeword_bits = params.lde_bits
        for step, arity_bits in zip(qr.steps, params.reduction_arity_bits):
            _check_exts(step.evals, 1 << arity_bits, d, "FRI step evals")
            codeword_bits -= arity_bits
            _check(len(step.merkle_proof) == codeword_bits - cap_height,
                   "FRI step merkle path length")
            _check_digests(step.merkle_proof, h, "FRI step merkle path")
    _check_exts(fri_proof.final_poly, params.final_poly_len, d,
                "FRI final poly")
