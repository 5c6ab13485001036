"""Lookups over BabyBear in the port against the JAX package, on the CPU,
exact (tolerance zero).  The lookup code is written once for both fields;
this holds it at BabyBear: the Tip5-16 circuit (``circuits.tip5_lookups``)
under ``standard_recursion_config_bb()``, built by both builders before
``build`` (live), and the port's build, witness (with the
multiplicities) and proof under ``NonRandomRng`` against the JAX ones
(``data/lookup_tip5_bb.npz``); the proof verifies and tampered copies do
not; the port's reader on the JAX writer's bytes of the circuit and
proof (``data/lookup_tip5_bb_{common,verifier,proof}.bin``).

The fixtures are written by the JAX package on the CPU with

    python tests/test_torch_lookups_bb.py --write-fixtures
"""

from __future__ import annotations

import copy
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
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import (  # noqa: E402
    DATA_DIR, circuit_meta, read_fixture)
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.plonk.proof import flatten_proof  # noqa: E402
from plonky2_goldibear_torch.plonk.verifier import \
    VerificationError  # noqa: E402

torch.set_num_threads(1)
SPEC = host.BABYBEAR
P = SPEC.p
NAME = "lookup_tip5_bb"


def data_path(suffix: str) -> str:
    return os.path.join(DATA_DIR, NAME + suffix)


def read_bin(part: str) -> bytes:
    with open(data_path(f"_{part}.bin"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def built():
    """(data, partial witness, proof from NonRandomRng(1), the counter
    after it), built and proved by the port on the CPU."""
    b = CircuitBuilder(CircuitConfig.standard_recursion_config_bb(), SPEC)
    ins = circuits.tip5_lookups(b)
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_targets(ins, circuits.TIP5_INPUTS)
    rng = NonRandomRng(1)
    proof = data.prove(pw, rng=rng)
    return data, pw, proof, rng.counter


def test_lookup_rows_match_jax_before_build():
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    port = CircuitBuilder(CircuitConfig.standard_recursion_config_bb(), SPEC)
    jax_ = JCircuitBuilder(JCircuitConfig.standard_recursion_config_bb(),
                           spec=jhost.BABYBEAR)
    for b in (port, jax_):
        circuits.tip5_lookups(b)
    assert [(i.gate.id(), i.constants) for i in port.gate_instances] == \
        [(i.gate.id(), i.constants) for i in jax_.gate_instances]
    assert port.luts == [tuple(map(tuple, lut)) for lut in jax_.luts]
    assert port.lut_to_lookups == jax_.lut_to_lookups
    assert port.copy_constraints == jax_.copy_constraints


def test_build_matches_jax(built):
    data = built[0]
    arrays, meta = read_fixture(data_path(".npz"))
    assert circuit_meta(data, "babybear") == meta
    np.testing.assert_array_equal(
        data.F.to_ints(data.prover_only.constants_sigmas_values),
        arrays["constants_sigmas"])
    np.testing.assert_array_equal(
        np.asarray(data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        arrays["constants_sigmas_cap"])


def test_witness_matches_jax(built):
    data, pw = built[0], built[1]
    arrays, _ = read_fixture(data_path(".npz"))
    rng = NonRandomRng(1)
    circuit = data.circuit(pw, rng)
    np.testing.assert_array_equal(circuit.F.to_ints(circuit.wires),
                                  arrays["wires"])
    assert circuit.public_inputs == [int(v) for v in arrays["public_inputs"]]
    assert rng.counter == int(arrays["counter"])


def test_proof_matches_jax_bit_for_bit(built):
    proof, counter = built[2], built[3]
    arrays, _ = read_fixture(data_path(".npz"))
    flat = flatten_proof(proof)
    differ = [k for k, v in flat.items()
              if not np.array_equal(v, arrays["proof_" + k])]
    assert not differ, f"proof phases {differ} differ from the JAX proof"
    assert counter == int(arrays["proof_counter"])


def test_proof_verifies_and_tampered_copies_do_not(built):
    data, proof = built[0], built[2]
    data.verify(proof)
    k = len(proof.public_inputs) // 2
    bad = copy.deepcopy(proof)
    bad.public_inputs[k] = (bad.public_inputs[k] + 1) % P
    with pytest.raises(VerificationError):
        data.verify(bad)
    bad = copy.deepcopy(proof)
    z = bad.proof.openings.lookup_zs[1]
    bad.proof.openings.lookup_zs[1] = ((z[0] + 1) % P,) + tuple(z[1:])
    with pytest.raises(VerificationError):
        data.verify(bad)


def test_reader_reads_the_jax_bb_lookup_bytes(built):
    data, proof = built[0], built[2]
    common = ser.read_common_circuit_data(read_bin("common"), SPEC)
    assert common.luts == data.common.luts
    assert [g.id() for g in common.gates] == [g.id() for g in
                                              data.common.gates]
    for name in ("num_lookup_polys", "num_lookup_selectors",
                 "num_constants", "num_gate_constraints", "config",
                 "fri_params", "k_is"):
        assert getattr(common, name) == getattr(data.common, name), name
    assert ser.read_verifier_only_circuit_data(read_bin("verifier"), SPEC) \
        == data.verifier_only
    read = ser.read_proof_with_public_inputs(read_bin("proof"), common)
    flat = flatten_proof(proof)
    for k, v in flatten_proof(read).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    data.verify(read)


# --------------------------------------------------------------------------
# the fixtures' writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def write_fixtures() -> None:
    """With the JAX package on the CPU, under ``set_nonrandom(True)``: the
    BB Tip5-16 circuit's build, witness and sync proof, and their bytes."""
    from test_torch_zk import _jax_setup, jax_prove_fixture

    _jax_setup()
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    b = JCircuitBuilder(JCircuitConfig.standard_recursion_config_bb(),
                        spec=jhost.BABYBEAR)
    ins = circuits.tip5_lookups(b)
    data = b.build()
    pw = JPartialWitness()
    pw.set_targets(ins, circuits.TIP5_INPUTS)
    jax_prove_fixture(data, pw, data_path(".npz"), bins=NAME, lookups=True,
                      field="babybear")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the BB lookup fixtures from the JAX package (or, "
                    "without --write-fixtures, run these tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    cli = ap.parse_args()
    if cli.write_fixtures:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        write_fixtures()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
