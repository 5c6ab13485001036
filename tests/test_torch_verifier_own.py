"""The port's verifier on the port's own proofs, on the CPU, exact.

Both fields' 2^6 arithmetic chains, built by the port's builder and proved
by its prover from ``NonRandomRng(1)`` (x = 3):

- the proof, and the proof of a retry whose first two attempts are made to
  fail (``InvZeroPermArg``, the random wire redrawn), verify with
  ``CircuitData.verify``; a tampered copy of each raises
  ``VerificationError``;
- the byte fixtures ``data/arith_chain{,_bb}_2e6_{common,verifier,
  proof}.bin`` (written by the JAX package, ``test_torch_verifier.py
  --write-fixtures``) read by the port equal the port's own build (common
  data, cap, digest) and proof, and the proof read verifies.
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

from plonky2_goldibear_torch import circuits  # noqa: E402
from plonky2_goldibear_torch.field import host  # noqa: E402
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.plonk import prover  # noqa: E402
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import \
    DATA_DIR  # noqa: E402
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.plonk.proof import (  # noqa: E402
    PROOF_PHASES, flatten_proof)
from plonky2_goldibear_torch.plonk.verifier import \
    VerificationError  # noqa: E402

torch.set_num_threads(1)
FIELDS = ("goldilocks", "babybear")
SPECS = {"goldilocks": host.GOLDILOCKS, "babybear": host.BABYBEAR}
PRESETS = {"goldilocks": "standard_recursion_config_gl",
           "babybear": "standard_recursion_config_bb"}
RETRY_FAILURES = 2


@pytest.fixture(scope="module")
def proved():
    """(data, proof, retry proof) of each field's 2^6 chain, built and
    proved by the port on the CPU once per module."""
    cache = {}

    def get(field):
        if field in cache:
            return cache[field]
        b = CircuitBuilder(getattr(CircuitConfig, PRESETS[field])(),
                           SPECS[field])
        x = circuits.arith_chain(b, 6)
        data = b.build(device="cpu")
        pw = PartialWitness()
        pw.set_target(x, 3)
        proof = data.prove(pw, rng=NonRandomRng(1))
        real, calls = prover._internal_prove, []

        def internal_prove(circuit, wires, timings, rng):
            calls.append(1)
            if len(calls) <= RETRY_FAILURES:
                raise prover.InvZeroPermArg()
            return real(circuit, wires, timings, rng)

        prover._internal_prove = internal_prove
        try:
            retry = data.prove(pw, rng=NonRandomRng(1))
        finally:
            prover._internal_prove = real
        assert len(calls) == RETRY_FAILURES + 1
        cache[field] = (data, proof, retry)
        return cache[field]

    return get


def _tampered(proof, p):
    bad = copy.deepcopy(proof)
    wires = bad.proof.openings.wires
    wires[0] = ((wires[0][0] + 1) % p,) + tuple(wires[0][1:])
    return bad


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("which", ["proof", "retry"])
def test_own_proof_verifies_and_a_tampered_copy_does_not(proved, field,
                                                         which):
    data, proof, retry = proved(field)
    pwpi = proof if which == "proof" else retry
    if which == "retry":
        assert flatten_proof(retry)["wires_cap"].tolist() != \
            flatten_proof(proof)["wires_cap"].tolist()
    data.verify(pwpi)
    with pytest.raises(VerificationError):
        data.verify(_tampered(pwpi, data.common.spec.p))


def _read(field):
    tag = "" if field == "goldilocks" else "bb_"

    def blob(part):
        path = os.path.join(DATA_DIR, f"arith_chain_{tag}2e6_{part}.bin")
        return open(path, "rb").read()

    common = ser.read_common_circuit_data(blob("common"), SPECS[field])
    return (common, ser.read_verifier_only_circuit_data(blob("verifier"),
                                                        SPECS[field]),
            ser.read_proof_with_public_inputs(blob("proof"), common))


@pytest.mark.parametrize("field", FIELDS)
def test_read_bytes_equal_the_own_build(proved, field):
    data = proved(field)[0]
    common, vk, _ = _read(field)
    built = data.common
    assert dataclasses.asdict(common.config) == \
        dataclasses.asdict(built.config)
    assert common.fri_params == built.fri_params
    assert [g.id() for g in common.gates] == [g.id() for g in built.gates]
    assert common.selectors_info.selector_indices == \
        built.selectors_info.selector_indices
    assert [tuple(g) for g in common.selectors_info.groups] == \
        [tuple(g) for g in built.selectors_info.groups]
    for name in ("quotient_degree_factor", "num_gate_constraints",
                 "num_constants", "num_public_inputs", "k_is",
                 "num_partial_products", "spec"):
        assert getattr(common, name) == getattr(built, name), name
    assert vk == data.verifier_only


@pytest.mark.parametrize("field", FIELDS)
def test_read_proof_equals_the_own_proof_and_verifies(proved, field):
    data, proof, _ = proved(field)
    common, vk, read = _read(field)
    flat, own = flatten_proof(read), flatten_proof(proof)
    for k in PROOF_PHASES:
        np.testing.assert_array_equal(flat[k], own[k])
    data.verify(read)
    from plonky2_goldibear_torch.plonk.verifier import verify
    verify(read, vk, common)
