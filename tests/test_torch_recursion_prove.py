"""A whole recursion with the port: an inner proof, the outer circuit that
verifies it (``circuits.recursive_verifier``), its witness, its proof,
``CircuitData.verify`` on it, and a tampered copy rejected.  Exact: the
inner proof must be a valid statement for the outer witness to exist, and
the outer proof must verify.

On the CPU the configuration is ``standard_recursion_config_gl()`` with one
FRI query round (``SMALL_QUERIES``) for inner and outer: the outer circuit
then has 2^10 rows (2^12 at the full 28 rounds, whose CPU commits would
take minutes).  On the card (``-m gpu``; skips without one) the full
configuration: the outer over the 2^12 chain, its common data, cap and
digest against the JAX build (``data/recursive_gl_2e12inner_*.bin``), its
proof verified; then the Keccak outer over that outer's proof (the top of
the reference's multi-hash tower, recursive_verifier.rs:623-664) against
``data/recursive_keccak_gl_2e12_*.bin``, proved and verified.

    python -m pytest --noconftest tests/test_torch_recursion_prove.py -q
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from plonky2_goldibear_torch import circuits  # noqa: E402
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import \
    DATA_DIR  # noqa: E402
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.plonk.verifier import \
    VerificationError  # noqa: E402
from plonky2_goldibear_torch.recursion import \
    recursive_verifier as rv  # noqa: E402

torch.set_num_threads(1)
SMALL_QUERIES = 1


def small_config():
    cfg = CircuitConfig.standard_recursion_config_gl()
    return dataclasses.replace(cfg, fri_config=dataclasses.replace(
        cfg.fri_config, num_query_rounds=SMALL_QUERIES))


def recurse(config, inner_bits, device):
    """Prove the arith chain of 2^inner_bits rows (x = 3), build the outer
    circuit over it, witness and prove it: (inner data, inner proof, outer
    data, outer proof, the outer's witness of an inner proof)."""
    b = CircuitBuilder(config)
    x = circuits.arith_chain(b, inner_bits)
    inner = b.build(device=device)
    pw = PartialWitness()
    pw.set_target(x, 3)
    inner_proof = inner.prove(pw, rng=NonRandomRng(1))
    inner.verify(inner_proof)
    ob = CircuitBuilder(config)
    proof_t, vk_t = circuits.recursive_verifier(ob, inner.common)
    outer = ob.build(device=device)

    def witness(proof):
        pw = PartialWitness()
        rv.set_proof_with_pis_target(pw, proof_t, proof)
        rv.set_verifier_data_target(pw, vk_t, inner.verifier_only)
        return pw

    outer_proof = outer.prove(witness(inner_proof), rng=NonRandomRng(1))
    return inner, inner_proof, outer, outer_proof, witness


def tampered(proof, p):
    bad = copy.deepcopy(proof)
    wires = bad.proof.openings.wires
    wires[0] = ((wires[0][0] + 1) % p,) + tuple(wires[0][1:])
    return bad


@pytest.fixture(scope="module")
def small():
    return recurse(small_config(), 6, "cpu")


def test_small_outer_size(small):
    _, _, outer, _, _ = small
    assert outer.common.degree_bits == 10
    assert len(outer.common.gates) == 13


def test_small_recursion_verifies(small):
    _, inner_proof, outer, outer_proof, _ = small
    assert outer_proof.public_inputs == inner_proof.public_inputs
    outer.verify(outer_proof)


def test_small_recursion_rejects_a_tampered_proof(small):
    _, _, outer, outer_proof, _ = small
    with pytest.raises(VerificationError):
        outer.verify(tampered(outer_proof, outer.common.spec.p))


def test_outer_witness_refuses_a_false_inner_proof(small):
    """An inner proof with one wire opening changed: the transcript's
    challenges move, the proof of work no longer passes its range check,
    and witness generation stops there (a generator meets a value its
    gate cannot hold, or a contradiction)."""
    inner, inner_proof, outer, _, witness = small
    with pytest.raises(AssertionError,
                       match="does not fit|contradictory assignment"):
        outer.circuit(witness(tampered(inner_proof, inner.common.spec.p)),
                      NonRandomRng(1))


@pytest.fixture(scope="module")
def full():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return recurse(CircuitConfig.standard_recursion_config_gl(), 12, "cuda")


def _read(name):
    with open(os.path.join(DATA_DIR, name), "rb") as f:
        return f.read()


@pytest.mark.gpu
def test_full_recursion_on_the_card(full):
    _, inner_proof, outer, outer_proof, _ = full
    assert outer.common.degree_bits == 12
    read_common = ser.read_common_circuit_data(open(os.path.join(
        DATA_DIR, "recursive_gl_2e12inner_common.bin"), "rb").read())
    assert [g.id() for g in read_common.gates] == \
        [g.id() for g in outer.common.gates]
    assert outer.verifier_only == ser.read_verifier_only_circuit_data(
        open(os.path.join(DATA_DIR, "recursive_gl_2e12inner_verifier.bin"),
             "rb").read())
    outer.verify(outer_proof)
    with pytest.raises(VerificationError):
        outer.verify(tampered(outer_proof, outer.common.spec.p))
    assert outer_proof.public_inputs == inner_proof.public_inputs


@pytest.mark.gpu
def test_keccak_outer_on_the_card(full):
    from plonky2_goldibear_torch.hash import keccak_hasher

    _, inner_proof, outer, outer_proof, _ = full
    kb = CircuitBuilder(CircuitConfig.standard_recursion_config_gl(),
                        hasher=keccak_hasher)
    proof_t, vk_t = circuits.recursive_verifier(kb, outer.common)
    keccak = kb.build(device="cuda")
    read_common = ser.read_common_circuit_data(_read(
        "recursive_keccak_gl_2e12_common.bin"))
    assert [g.id() for g in read_common.gates] == \
        [g.id() for g in keccak.common.gates]
    assert keccak.verifier_only == ser.read_verifier_only_circuit_data(
        _read("recursive_keccak_gl_2e12_verifier.bin"), hasher=keccak_hasher)
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, outer_proof)
    rv.set_verifier_data_target(pw, vk_t, outer.verifier_only)
    proof = keccak.prove(pw, rng=NonRandomRng(1))
    assert all(isinstance(d, bytes) for d in proof.proof.wires_cap)
    keccak.verify(proof)
    with pytest.raises(VerificationError):
        keccak.verify(tampered(proof, keccak.common.spec.p))
    assert proof.public_inputs == inner_proof.public_inputs
