"""Recursion over a lookup proof, and the 2^16-entry table, in the port
against the JAX package (tolerance zero: rows, copies, caps, digests and
witness columns compared with equality).

(a) The recursive verifier over the Tip5-16 lookup circuit
    (``circuits.tip5_lookups``; reference recursive_verifier.rs:341-413):
    built by both builders before ``build`` (live: the lookup deltas, the
    lookup Z openings, each table's polynomial at delta and the logUp
    terms in the circuit), then the port's build on the CPU and its
    witness of the stored JAX proof against
    ``data/lookup_recursive_{common,verifier}.bin`` and
    ``data/lookup_recursive.npz`` (a SHA-256 of every wire column).
(b) On the card (``-m gpu``): that outer proved and verified; the
    2^16-entry table (``circuits.u16_table``, 2^12 rows) built equal to
    ``data/lookup_u16_{common,verifier}.bin``, its lookup polys equal to
    the scalar host reference, its proof verified and a tampered output
    rejected.

The fixtures are written by ``python tests/test_torch_lookups.py
--write-fixtures``.
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
for d in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if d not in sys.path:
        sys.path.insert(0, d)

from plonky2_goldibear_torch import circuits  # noqa: E402
from plonky2_goldibear_torch.field import gl, host  # noqa: E402
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.plonk import prover  # noqa: E402
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk.verifier import (  # noqa: E402
    VerificationError)
from plonky2_goldibear_torch.recursion import \
    recursive_verifier as rv  # noqa: E402
from test_torch_lookups import (_jax_builder, _port_builder,  # noqa: E402
                                column_digests, npz_path, read_bin)
from test_torch_zk import assert_common_equal  # noqa: E402

torch.set_num_threads(1)
P = host.GOLDILOCKS.p


def _tip5():
    """The Tip5-16 circuit's common data, verifier data and JAX proof, as
    the port reads the JAX writer's bytes."""
    common = ser.read_common_circuit_data(read_bin("tip5_common"))
    return (common,
            ser.read_verifier_only_circuit_data(read_bin("tip5_verifier")),
            ser.read_proof_with_public_inputs(read_bin("tip5_proof"),
                                              common))


def _state(b):
    return ([(i.gate.id(), i.constants) for i in b.gate_instances],
            b.copy_constraints, b.constants_to_targets, b.public_inputs,
            b.current_slots, b.virtual_target_index)


def test_outer_matches_jax_before_build():
    """The outer over the Tip5-16 circuit, built by both builders over its
    common data as each package reads the JAX writer's bytes (the JAX
    reader leaves out the tables: they are given to it)."""
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    port, jax_ = _port_builder(), _jax_builder()
    common = _tip5()[0]
    jcommon = dataclasses.replace(jser.read_common_circuit_data(
        read_bin("tip5_common")), luts=common.luts)
    circuits.recursive_verifier(port, common)
    circuits.recursive_verifier(jax_, jcommon, rv=jrv)
    assert _state(port) == _state(jax_)
    assert len(port.generators) == len(jax_.generators)


@pytest.fixture(scope="module")
def outer():
    """(data, circuit with the witness of the JAX Tip5-16 proof, rng),
    built by the port on the CPU."""
    common, vk, proof = _tip5()
    b = _port_builder()
    proof_t, vk_t = circuits.recursive_verifier(b, common)
    data = b.build(device="cpu")
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, proof)
    rv.set_verifier_data_target(pw, vk_t, vk)
    rng = NonRandomRng(1)
    return data, data.circuit(pw, rng), rng


def test_outer_build_matches_jax(outer):
    data, _, _ = outer
    assert_common_equal(ser.read_common_circuit_data(
        read_bin("recursive_common")), data.common)
    assert data.verifier_only == ser.read_verifier_only_circuit_data(
        read_bin("recursive_verifier"))


def test_outer_witness_matches_jax_column_by_column(outer):
    data, circuit, rng = outer
    with np.load(npz_path("recursive")) as z:
        want, pis, counter = z["column_sha256"], z["public_inputs"], \
            int(z["counter"])
    got = column_digests(circuit.F.to_ints(circuit.wires))
    bad = [c for c in range(len(want)) if not np.array_equal(got[c],
                                                             want[c])]
    assert not bad, f"wire columns {bad} differ from the JAX witness"
    assert circuit.public_inputs == [int(v) for v in pis]
    assert rng.counter == counter
    assert circuit.public_inputs == list(_tip5()[2].public_inputs)


# --------------------------------------------------------------------------
# (b) on the card
# --------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a 2^12 commit and prove")


@pytest.mark.gpu
def test_lookup_recursion_proves_on_the_card():
    _need_card()
    common, vk, proof = _tip5()
    b = _port_builder()
    proof_t, vk_t = circuits.recursive_verifier(b, common)
    data = b.build()
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, proof)
    rv.set_verifier_data_target(pw, vk_t, vk)
    out = data.prove(pw, rng=NonRandomRng(1))
    data.verify(out)
    assert out.public_inputs == proof.public_inputs
    bad = copy.deepcopy(out)
    w = bad.proof.openings.wires
    w[3] = ((w[3][0] + 1) % P,) + tuple(w[3][1:])
    with pytest.raises(VerificationError):
        data.verify(bad)


@pytest.mark.gpu
def test_u16_table_builds_and_proves_on_the_card():
    _need_card()
    b = _port_builder()
    ins = circuits.u16_table(b)
    data = b.build()
    assert data.common.degree_bits == 12
    assert_common_equal(ser.read_common_circuit_data(read_bin(
        "u16_common")), data.common)
    assert data.verifier_only == ser.read_verifier_only_circuit_data(
        read_bin("u16_verifier"))
    pw = PartialWitness()
    pw.set_targets(ins, circuits.u16_inputs())
    circuit = data.circuit(pw, np.random.default_rng(1))
    deltas = [5, 7, 11, 13]
    np.testing.assert_array_equal(
        gl.to_ints(prover.compute_lookup_polys(
            gl, data.common, circuit.lookup_rows, circuit.wires, deltas)),
        np.asarray(prover.compute_lookup_polys_host(
            data.common, circuit.lookup_rows, gl.to_ints(circuit.wires),
            deltas), np.uint64))
    proof = prover.prove(circuit)
    data.verify(proof)
    assert proof.public_inputs == [
        circuits.u16_rotl(x) for x in
        circuits.u16_inputs()[:4] + circuits.u16_inputs()[-4:]]
    bad = copy.deepcopy(proof)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    with pytest.raises(VerificationError):
        data.verify(bad)
