"""The port's verifier and proof reading against the JAX package, on the
CPU, exact (no tolerance: field values, digests and challenges compared
with equality).

(a) The reference's own recursive-verifier proof,
    ``tests/data/gl_regression_{common,verifier,proof}.bin`` (degree 2^14,
    ``standard_recursion_zk_config_gl``, 12 gates, 123 gate constraints,
    zk with salted leaves): the port's reading equals the JAX reader's
    field by field, the port verifies it, its challenges and its
    vanishing polynomial at zeta equal JAX's, and every tampered copy is
    rejected by the port (``VerificationError``) and by the JAX verifier.
(b) The byte fixtures of the port's own circuits,
    ``plonky2_goldibear_torch/data/arith_chain{,_bb}_2e6_{common,verifier,
    proof}.bin`` (the 2^6 arithmetic chains and their JAX proofs, written
    by the JAX package's writers): read by both packages, the challenges
    of both fields equal JAX's.  ``test_torch_verifier_own.py`` holds them
    against the port's own build and proof.

The byte fixtures are written with the JAX package (its build of the chain,
its stored proof from ``arith_chain{,_bb}_2e6.npz``, its verifier, its
writers) by

    python tests/test_torch_verifier.py --write-fixtures [--field babybear]
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from plonky2_goldibear_torch.field import host  # noqa: E402
from plonky2_goldibear_torch.gates.base import (  # noqa: E402
    EvaluationVars, HostExtAlgebra)
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk import vanishing  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import (  # noqa: E402
    DATA_DIR, fixture_path, hasher_of, read_fixture)
from plonky2_goldibear_torch.plonk.get_challenges import \
    get_challenges  # noqa: E402
from plonky2_goldibear_torch.plonk.proof import (  # noqa: E402
    PROOF_PHASES, flatten_proof)
from plonky2_goldibear_torch.plonk.verifier import (  # noqa: E402
    VerificationError, verify)

torch.set_num_threads(1)
FIELDS = ("goldilocks", "babybear")
SPECS = {"goldilocks": host.GOLDILOCKS, "babybear": host.BABYBEAR}
RUST = os.path.join(ROOT, "tests", "data", "gl_regression_{}.bin")


def bin_path(field: str, part: str) -> str:
    """A byte fixture of the 2^6 chain: ``part`` common, verifier or
    proof."""
    tag = "" if field == "goldilocks" else "bb_"
    return os.path.join(DATA_DIR, f"arith_chain_{tag}2e6_{part}.bin")


def _jax(field: str = "goldilocks"):
    """(spec, hasher) of the JAX package for ``field``."""
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.hash import poseidon2_bb, poseidon_gl
    if field == "babybear":
        return jhost.BABYBEAR, poseidon2_bb
    return jhost.GOLDILOCKS, poseidon_gl


def read_both(paths, field="goldilocks"):
    """(port (common, vk, proof), JAX (common, vk, proof)) of three byte
    files, read by each package's reader."""
    from plonky2_goldibear_tpu.plonk import serialization as jser
    jspec, jhasher = _jax(field)
    data = [open(p, "rb").read() for p in paths]
    common = ser.read_common_circuit_data(data[0], SPECS[field])
    port = (common,
            ser.read_verifier_only_circuit_data(data[1], SPECS[field]),
            ser.read_proof_with_public_inputs(data[2], common))
    jcommon = jser.read_common_circuit_data(data[0], jspec)
    jax_ = (jcommon,
            jser.read_verifier_only_circuit_data(data[1], jspec, jhasher),
            jser.read_proof_with_public_inputs(data[2], jcommon, jhasher))
    return port, jax_


@pytest.fixture(scope="module")
def rust():
    return read_both([RUST.format(p) for p in ("common", "verifier",
                                               "proof")])


@pytest.fixture(scope="module")
def bins():
    cache = {}

    def get(field):
        if field not in cache:
            cache[field] = read_both(
                [bin_path(field, p) for p in ("common", "verifier",
                                              "proof")], field)
        return cache[field]

    return get


def _challenges(common, vk, proof, hasher):
    pi_hash = hasher.hash_no_pad_host(proof.public_inputs)
    return get_challenges(proof, pi_hash, vk.circuit_digest, common, hasher)


def _jax_challenges(jcommon, jvk, jproof, field="goldilocks"):
    from plonky2_goldibear_tpu.plonk.get_challenges import \
        get_challenges as jget
    _, jhasher = _jax(field)
    pi_hash = jhasher.hash_no_pad_host(jproof.public_inputs)
    return jget(jproof, pi_hash, jvk.circuit_digest, jcommon, jhasher)


# --------------------------------------------------------------------------
# (a) the reference's recursive-verifier proof
# --------------------------------------------------------------------------


def test_rust_common_reads_as_jax(rust):
    (common, _, _), (jcommon, _, _) = rust
    assert common.degree_bits == 14
    assert common.num_gate_constraints == 123
    assert len(common.gates) == 12
    assert common.config.zero_knowledge and common.fri_params.hiding
    assert dataclasses.asdict(common.config) == \
        dataclasses.asdict(jcommon.config)
    assert dataclasses.asdict(common.fri_params) == \
        dataclasses.asdict(jcommon.fri_params)
    assert common.selectors_info.selector_indices == \
        jcommon.selectors_info.selector_indices
    assert [tuple(g) for g in common.selectors_info.groups] == \
        [tuple(g) for g in jcommon.selectors_info.groups]
    assert common.k_is == jcommon.k_is
    assert [g.id() for g in common.gates] == [g.id() for g in jcommon.gates]
    for name in ("quotient_degree_factor", "num_gate_constraints",
                 "num_constants", "num_public_inputs",
                 "num_partial_products", "num_lookup_polys",
                 "num_lookup_selectors", "lde_size"):
        assert getattr(common, name) == getattr(jcommon, name), name
    assert [dataclasses.astuple(o) for o in common.fri_oracles()] == \
        [dataclasses.astuple(o) for o in jcommon.fri_oracles()]
    for g, jg in zip(common.gates, jcommon.gates):
        assert (g.num_wires(), g.num_constants(), g.degree(),
                g.num_constraints()) == (jg.num_wires(), jg.num_constants(),
                                         jg.degree(), jg.num_constraints())


def test_rust_verifier_data_reads_as_jax(rust):
    (_, vk, _), (_, jvk, _) = rust
    assert len(vk.constants_sigmas_cap) == 16
    assert vk.constants_sigmas_cap == jvk.constants_sigmas_cap
    assert vk.circuit_digest == jvk.circuit_digest


@pytest.mark.parametrize("phase", PROOF_PHASES)
def test_rust_proof_reads_as_jax(rust, phase):
    """Caps, openings, FRI caps, final polynomial, PoW witness and every
    query round (leaves with their salts, siblings, steps)."""
    (_, _, proof), (_, _, jproof) = rust
    np.testing.assert_array_equal(flatten_proof(proof)[phase],
                                  flatten_proof(jproof)[phase])


def test_rust_proof_verifies(rust):
    (common, vk, proof), _ = rust
    verify(proof, vk, common)


def test_rust_challenges_match_jax(rust):
    port, jax_ = rust
    got = _challenges(*port, hasher_of(port[0].spec))
    want = _jax_challenges(*jax_)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == want[k], k


def test_rust_vanishing_terms_match_jax(rust):
    """The gate constraints and vanishing_polys_zeta at zeta, from the
    same challenges."""
    from plonky2_goldibear_tpu.gates.base import EvaluationVars as JVars
    from plonky2_goldibear_tpu.gates.base import HostExtAlgebra as JA
    from plonky2_goldibear_tpu.plonk import vanishing as jvan

    (common, vk, proof), (jcommon, _, _) = rust
    hasher = hasher_of(common.spec)
    jspec, jhasher = _jax()
    ch = _challenges(common, vk, proof, hasher)
    pi_hash = hasher.hash_no_pad_host(proof.public_inputs)
    o = proof.proof.openings
    zeta = ch["plonk_zeta"]
    zeta_n = host.ext_pow(common.spec, zeta, common.degree)

    A, JAl = HostExtAlgebra(common.spec), JA(jspec)
    vars_ = EvaluationVars(o.constants, o.wires,
                           [A.from_int(x) for x in pi_hash])
    jvars = JVars(o.constants, o.wires, [JAl.from_int(x) for x in pi_hash])
    assert vanishing.evaluate_gate_constraints_a(A, common, vars_) == \
        jvan.evaluate_gate_constraints(JAl, jcommon, jvars)

    l_0 = vanishing.eval_l_0_host(A, common.degree, zeta, zeta_n)
    assert l_0 == jvan.eval_l_0_host(JAl, common.degree, zeta, zeta_n)
    args = (zeta, l_0)
    rest = (o.plonk_zs, o.plonk_zs_next, o.partial_products, o.plonk_sigmas,
            ch["plonk_betas"], ch["plonk_gammas"], ch["plonk_alphas"])
    got = vanishing.eval_vanishing_poly_a(A, common, *args, vars_, *rest)
    want = jvan.eval_vanishing_poly(JAl, jcommon, *args, jvars, *rest)
    assert [tuple(v) for v in got] == [tuple(v) for v in want]


def _bump_ext(values, i, p):
    values[i] = ((values[i][0] + 1) % p,) + tuple(values[i][1:])


def _bump(values, i, p):
    values[i] = (values[i] + 1) % p


def _round(pwpi, k=0):
    return pwpi.proof.opening_proof.query_round_proofs[k]


# One field of the proof changed in each copy; ``p`` is the modulus.
TAMPERS = {
    "wire_opening": lambda w, p: _bump_ext(w.proof.openings.wires, 3, p),
    "quotient_opening": lambda w, p: _bump_ext(
        w.proof.openings.quotient_polys, 1, p),
    "constants_opening": lambda w, p: _bump_ext(
        w.proof.openings.constants, 0, p),
    "initial_tree_leaf": lambda w, p: _bump(
        _round(w).initial_trees_proof.evals_proofs[1][0], 5, p),
    "leaf_salt": lambda w, p: _bump(
        _round(w, 3).initial_trees_proof.evals_proofs[3][0], -1, p),
    "merkle_sibling": lambda w, p: _bump(
        _round(w).initial_trees_proof.evals_proofs[2][1][0], 0, p),
    "fri_step_eval": lambda w, p: _bump_ext(_round(w, 1).steps[0].evals, 2,
                                            p),
    "fri_commit_cap": lambda w, p: _bump(
        w.proof.opening_proof.commit_phase_merkle_caps[0][5], 1, p),
    "pow_witness": lambda w, p: setattr(
        w.proof.opening_proof, "pow_witness",
        (w.proof.opening_proof.pow_witness + 1) % p),
    "final_poly_coefficient": lambda w, p: _bump_ext(
        w.proof.opening_proof.final_poly, 0, p),
}


@pytest.mark.parametrize("tamper", sorted(TAMPERS))
def test_rust_tampered_copy_is_rejected(rust, tamper):
    from plonky2_goldibear_tpu.fri.verifier import FriVerificationError
    from plonky2_goldibear_tpu.plonk.verifier import \
        VerificationError as JVerificationError
    from plonky2_goldibear_tpu.plonk.verifier import verify as jverify

    (common, vk, proof), (jcommon, jvk, jproof) = rust
    p = common.spec.p
    bad, jbad = copy.deepcopy(proof), copy.deepcopy(jproof)
    TAMPERS[tamper](bad, p)
    TAMPERS[tamper](jbad, p)
    flat, good = flatten_proof(bad), flatten_proof(proof)
    assert any(not np.array_equal(flat[k], good[k]) for k in PROOF_PHASES)
    with pytest.raises(VerificationError):
        verify(bad, vk, common)
    with pytest.raises((JVerificationError, FriVerificationError)):
        jverify(jbad, jvk, jcommon)


def test_rust_malformed_proof_is_rejected(rust):
    """A proof of the wrong shape fails the shape check, not part way."""
    (common, vk, proof), _ = rust
    bad = copy.deepcopy(proof)
    bad.proof.opening_proof.query_round_proofs.pop()
    with pytest.raises(VerificationError, match="malformed"):
        verify(bad, vk, common)


# --------------------------------------------------------------------------
# (b) the byte fixtures of the port's circuits
# --------------------------------------------------------------------------


@pytest.mark.parametrize("field", FIELDS)
def test_fixture_bytes_read_as_jax(bins, field):
    (common, vk, proof), (jcommon, jvk, jproof) = bins(field)
    assert [g.id() for g in common.gates] == [g.id() for g in jcommon.gates]
    assert dataclasses.asdict(common.config) == \
        dataclasses.asdict(jcommon.config)
    assert common.k_is == jcommon.k_is
    assert vk.constants_sigmas_cap == jvk.constants_sigmas_cap
    assert vk.circuit_digest == jvk.circuit_digest
    flat, jflat = flatten_proof(proof), flatten_proof(jproof)
    for k in PROOF_PHASES:
        np.testing.assert_array_equal(flat[k], jflat[k])


@pytest.mark.parametrize("field", FIELDS)
def test_fixture_challenges_match_jax(bins, field):
    port, jax_ = bins(field)
    got = _challenges(*port, hasher_of(port[0].spec))
    want = _jax_challenges(*jax_, field)
    for k in want:
        assert got[k] == want[k], k


def test_unported_parts_raise_with_their_item():
    """Gate tag 17 (AddManyGate, ROADMAP Queue 1 item 4b) reads now: its
    two fields, and the id the reference prints; an unknown tag raises."""
    from plonky2_goldibear_torch.gates.misc_gates import AddManyGate

    def tag(n, fields=(0, 0)):
        return ser._read_gate(ser.Buffer(n.to_bytes(4, "little") + b"".join(
            v.to_bytes(8, "little") for v in fields)), host.GOLDILOCKS, None)

    gate = tag(17, (23, 3))
    assert gate == AddManyGate(23, 3)
    assert gate.id() == "AddManyGate { num_addends: 23, num_ops: 3 }"
    with pytest.raises(ValueError, match="unknown gate tag 20"):
        tag(20)


# --------------------------------------------------------------------------
# the byte fixtures' writer (JAX package, CPU)
# --------------------------------------------------------------------------


def jax_proof(flat, common):
    """The JAX package's proof of ``flatten_proof``'s arrays, its shape
    read from the JAX ``common`` (non-hiding: no salts)."""
    from plonky2_goldibear_tpu.plonk import proof as jp

    config, params = common.config, common.fri_params
    d, h = common.spec.ext_degree, common.spec.num_hash_out_elts
    ch, nch = config.fri_config.cap_height, config.num_challenges
    assert not params.hiding

    def reader(key):
        vals = iter(int(v) for v in flat[key])
        return lambda n: [next(vals) for _ in range(n)]

    def caps(take, count):
        return [[take(h) for _ in range(1 << ch)] for _ in range(count)]

    def exts(take, n):
        return [tuple(take(d)) for _ in range(n)]

    take = reader("openings")
    o = [exts(take, n) for n in (
        common.num_constants, config.num_routed_wires, config.num_wires, nch,
        nch * common.num_partial_products, common.num_quotient_polys(),
        nch)]
    openings = jp.OpeningSet(
        constants=o[0], plonk_sigmas=o[1], wires=o[2], plonk_zs=o[3],
        partial_products=o[4], quotient_polys=o[5], plonk_zs_next=o[6])
    take = reader("query_rounds")
    rounds = []
    for _ in range(config.fri_config.num_query_rounds):
        init = [(take(o.num_polys), [take(h) for _ in range(
            params.lde_bits - ch)]) for o in common.fri_oracles()]
        steps, bits = [], params.lde_bits
        for ar in params.reduction_arity_bits:
            bits -= ar
            steps.append(jp.FriQueryStep(
                evals=exts(take, 1 << ar),
                merkle_proof=[take(h) for _ in range(bits - ch)]))
        rounds.append(jp.FriQueryRound(
            initial_trees_proof=jp.FriInitialTreeProof(init), steps=steps))
    proof = jp.Proof(
        wires_cap=caps(reader("wires_cap"), 1)[0],
        plonk_zs_partial_products_cap=caps(reader("zs_pp_cap"), 1)[0],
        quotient_polys_cap=caps(reader("quotient_cap"), 1)[0],
        openings=openings,
        opening_proof=jp.FriProof(
            commit_phase_merkle_caps=caps(
                reader("fri_caps"), len(params.reduction_arity_bits)),
            query_round_proofs=rounds,
            final_poly=exts(reader("final_poly"), params.final_poly_len),
            pow_witness=int(flat["pow_witness"][0])))
    pwpi = jp.ProofWithPublicInputs(
        proof=proof, public_inputs=[int(v) for v in flat["public_inputs"]])
    back = flatten_proof(pwpi)
    assert all(np.array_equal(back[k], flat[k]) for k in PROOF_PHASES)
    return pwpi


def write_bin_fixtures(field: str) -> None:
    """Build the 2^6 chain with the JAX builder, check it against the npz
    fixture, rebuild the stored JAX proof, verify it with the JAX verifier
    and write the three files with the JAX package's writers."""
    import time

    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.plonk.builder import CircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import CircuitConfig
    from plonky2_goldibear_tpu.plonk.verifier import verify as jverify

    from plonky2_goldibear_torch.circuits import arith_chain

    t0 = time.time()
    jspec, jhasher = _jax(field)
    preset = ("standard_recursion_config_bb" if field == "babybear"
              else "standard_recursion_config_gl")
    b = CircuitBuilder(getattr(CircuitConfig, preset)(), spec=jspec)
    arith_chain(b, 6)
    data = b.build()
    arrays, meta = read_fixture(fixture_path(6, field))
    assert data.verifier_only.circuit_digest == meta["circuit_digest"]
    np.testing.assert_array_equal(
        np.asarray(data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        arrays["constants_sigmas_cap"])
    proof = jax_proof({k: arrays["proof_" + k] for k in PROOF_PHASES},
                      data.common)
    jverify(proof, data.verifier_only, data.common, hasher=jhasher)
    parts = {
        "common": jser.write_common_circuit_data(data.common),
        "verifier": jser.write_verifier_only_circuit_data(
            data.verifier_only, jspec),
        "proof": jser.write_proof_with_public_inputs(proof, data.common),
    }
    for part, blob in parts.items():
        with open(bin_path(field, part), "wb") as f:
            f.write(blob)
        print(f"wrote {bin_path(field, part)} ({len(blob)} bytes)")
    print(f"{field}: {time.time() - t0:.1f} s")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write-fixtures", action="store_true", required=True)
    ap.add_argument("--field", choices=FIELDS, default="goldilocks")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    write_bin_fixtures(args.field)
