"""The Keccak config (the reference's KeccakGoldilocksConfig: Keccak commits
and runs the transcript, Poseidon-GL hashes in the circuit and hashes the
public inputs) in the port, against the JAX package, on the CPU, exact
(tolerance zero: rows, field values, byte digests and proofs compared with
equality).

(a) The small circuit of the JAX package's ``tests/test_keccak_config.py``
    (``circuits.keccak_pow31``: x^31, 8 PoW bits), built with
    ``hasher=keccak_hasher``: its build (metadata, constants/sigmas, cap
    and digest bytes) and witness against ``data/keccak_pow31.npz``; its
    proof from ``NonRandomRng(1)`` against the JAX proof read from
    ``data/keccak_pow31_proof.bin``, field by field, byte digests
    included (the PoW witness too: the grind returns the smallest); the
    port verifies the JAX proof and rejects tampered copies; the reader
    on the JAX bytes; the circuit loaded as data proves the same proof.
(b) The Keccak outer (the top of the reference's multi-hash tower,
    recursive_verifier.rs:623-664) over the Poseidon outer of the 2^6
    chain (``recursive_gl_2e6inner_common.bin``): built by both builders
    before ``build`` (live), and the port's build against
    ``data/recursive_keccak_gl_2e6_{common,verifier}.bin``.
(c) What the config refuses: Keccak over BabyBear, Keccak in a hashing
    gadget, a recursive verifier over a Keccak inner proof.

The fixtures are written by the JAX package on the CPU with

    python tests/test_torch_keccak_config.py --write-fixtures
"""

from __future__ import annotations

import copy
import json
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
from plonky2_goldibear_torch.hash import keccak_hasher  # noqa: E402
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.plonk import prover  # noqa: E402
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import (  # noqa: E402
    DATA_DIR, circuit_meta, load_circuit, read_fixture)
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.plonk.proof import (  # noqa: E402
    PROOF_PHASES, flatten_proof)
from plonky2_goldibear_torch.plonk.verifier import (  # noqa: E402
    VerificationError, verify)
from plonky2_goldibear_torch.recursion import \
    recursive_verifier as rv  # noqa: E402

torch.set_num_threads(1)
P = host.GOLDILOCKS.p
POW31 = "keccak_pow31"


def data_path(name: str) -> str:
    return os.path.join(DATA_DIR, name)


def read_bin(name: str) -> bytes:
    with open(data_path(name + ".bin"), "rb") as f:
        return f.read()


def _port_builder(config=None):
    return CircuitBuilder(config or circuits.keccak_pow31_config(
        CircuitConfig), hasher=keccak_hasher)


# --------------------------------------------------------------------------
# (a) the small circuit
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    """(data, circuit with the witness of x = 3, rng after witness
    generation, proof from that rng, fixture arrays, fixture meta), built
    and proved by the port on the CPU."""
    b = _port_builder()
    x = circuits.keccak_pow31(b)
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_target(x, circuits.KECCAK_POW31_INPUT)
    rng = NonRandomRng(1)
    circuit = data.circuit(pw, rng)
    counter = rng.counter
    proof = prover.prove(circuit, device="cpu", rng=rng)
    arrays, meta = read_fixture(data_path(POW31 + ".npz"))
    return data, circuit, counter, proof, arrays, meta


@pytest.fixture(scope="module")
def jax_bytes():
    """(common, verifier data, proof) of the JAX build and proof, read by
    the port's reader from the JAX writers' bytes."""
    common = ser.read_common_circuit_data(read_bin(POW31 + "_common"))
    return (common,
            ser.read_verifier_only_circuit_data(
                read_bin(POW31 + "_verifier"), hasher=keccak_hasher),
            ser.read_proof_with_public_inputs(
                read_bin(POW31 + "_proof"), common, hasher=keccak_hasher))


def test_small_build_matches_jax(small, jax_bytes):
    data, _, _, _, arrays, meta = small
    common, vk, _ = jax_bytes
    assert circuit_meta(data, "goldilocks") == meta
    assert meta["hasher"] == "keccak"
    np.testing.assert_array_equal(
        data.F.to_ints(data.prover_only.constants_sigmas_values),
        arrays["constants_sigmas"])
    assert data.verifier_only == vk
    assert isinstance(vk.circuit_digest, bytes) and \
        len(vk.circuit_digest) == keccak_hasher.HASH_SIZE
    assert all(isinstance(d, bytes) for d in vk.constants_sigmas_cap)
    assert [g.id() for g in data.common.gates] == \
        [g.id() for g in common.gates]
    assert data.common.fri_params == common.fri_params
    assert data.common.config.fri_config.proof_of_work_bits == 8


def test_small_witness_matches_jax(small):
    _, circuit, counter, _, arrays, _ = small
    np.testing.assert_array_equal(circuit.F.to_ints(circuit.wires),
                                  arrays["wires"])
    assert circuit.public_inputs == [3, pow(3, 31, P)] == \
        [int(v) for v in arrays["public_inputs"]]
    assert counter == int(arrays["counter"])


@pytest.mark.parametrize("phase", PROOF_PHASES)
def test_small_proof_matches_jax_bit_for_bit(small, jax_bytes, phase):
    """Each phase of the port's proof equals the JAX proof's, byte digests
    as their bytes' values; the PoW witness is the smallest."""
    proof = small[3]
    np.testing.assert_array_equal(flatten_proof(proof)[phase],
                                  flatten_proof(jax_bytes[2])[phase])


def test_small_proof_has_byte_digests_and_pi_hash_of_poseidon(small):
    data, circuit, _, proof, _, _ = small
    p = proof.proof
    for cap in (p.wires_cap, p.plonk_zs_partial_products_cap,
                p.quotient_polys_cap,
                *p.opening_proof.commit_phase_merkle_caps):
        assert all(isinstance(d, bytes) and len(d) == 25 for d in cap)
    for qr in p.opening_proof.query_round_proofs:
        for _, sibs in qr.initial_trees_proof.evals_proofs:
            assert all(isinstance(d, bytes) for d in sibs)
    assert circuit.hasher is keccak_hasher
    assert circuit.inner_hasher.__name__.endswith("poseidon_gl")


def test_port_verifies_the_jax_proof_and_rejects_tampered_copies(
        small, jax_bytes):
    data = small[0]
    common, vk, proof = jax_bytes
    verify(proof, vk, common, hasher=keccak_hasher)
    data.verify(proof)
    data.verify(small[3])

    def cap_byte(pr):
        cap = pr.proof.wires_cap
        cap[0] = bytes([cap[0][0] ^ 1]) + cap[0][1:]

    def sibling_byte(pr):
        sibs = pr.proof.opening_proof.query_round_proofs[0] \
            .initial_trees_proof.evals_proofs[1][1]
        sibs[0] = sibs[0][:-1] + bytes([sibs[0][-1] ^ 0x80])

    def public_input(pr):
        pr.public_inputs[1] = (pr.public_inputs[1] + 1) % P

    def pow_witness(pr):
        pr.proof.opening_proof.pow_witness += 1

    def short_digest(pr):
        pr.proof.quotient_polys_cap[3] = pr.proof.quotient_polys_cap[3][:24]

    for tamper in (cap_byte, sibling_byte, public_input, pow_witness,
                   short_digest):
        bad = copy.deepcopy(proof)
        tamper(bad)
        with pytest.raises(VerificationError):
            data.verify(bad)


def test_reader_reads_the_jax_bytes(jax_bytes, small):
    common, vk, proof = jax_bytes
    assert common.num_public_inputs == 2 and common.degree_bits == \
        small[0].common.degree_bits
    assert proof.public_inputs == [3, pow(3, 31, P)]
    # without the hasher, the same bytes do not read as a proof
    with pytest.raises(ValueError):
        ser.read_proof_with_public_inputs(read_bin(POW31 + "_proof"), common)
    with pytest.raises(ValueError):
        ser.read_verifier_only_circuit_data(read_bin(POW31 + "_verifier"))


def test_loaded_keccak_circuit_proves_as_jax(small, jax_bytes):
    """The circuit carried across as data (``load_circuit`` reads the
    metadata's hasher) proves the JAX proof."""
    _, _, _, _, arrays, meta = small
    circuit = load_circuit(arrays, meta, device="cpu")
    assert circuit.hasher is keccak_hasher
    assert circuit.verifier_data() == jax_bytes[1]
    proof = prover.prove(circuit, device="cpu",
                         rng=NonRandomRng(int(arrays["counter"])))
    got, want = flatten_proof(proof), flatten_proof(jax_bytes[2])
    for phase in PROOF_PHASES:
        np.testing.assert_array_equal(got[phase], want[phase])


# --------------------------------------------------------------------------
# (b) the Keccak outer over the 2^6 chain's Poseidon outer
# --------------------------------------------------------------------------


def _inner_common():
    with open(data_path("recursive_gl_2e6inner_common.bin"), "rb") as f:
        return f.read()


def _jax_keccak_builder():
    from plonky2_goldibear_tpu.hash import keccak_hasher as jkeccak
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    return JCircuitBuilder(JCircuitConfig.standard_recursion_config_gl(),
                           hasher=jkeccak)


def _state(b):
    return ([(i.gate.id(), i.constants) for i in b.gate_instances],
            b.copy_constraints, b.constants_to_targets, b.public_inputs,
            b.current_slots, b.virtual_target_index)


def test_keccak_outer_matches_jax_before_build():
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    port = _port_builder(CircuitConfig.standard_recursion_config_gl())
    jax_ = _jax_keccak_builder()
    circuits.recursive_verifier(port, ser.read_common_circuit_data(
        _inner_common()))
    circuits.recursive_verifier(jax_, jser.read_common_circuit_data(
        _inner_common()), rv=jrv)
    assert _state(port) == _state(jax_)
    assert len(port.generators) == len(jax_.generators)
    assert port.hasher is keccak_hasher
    ids = {i.gate.id() for i in port.gate_instances}
    assert "PoseidonGate<WIDTH=12>" in ids


@pytest.fixture(scope="module")
def keccak_outer():
    b = _port_builder(CircuitConfig.standard_recursion_config_gl())
    circuits.recursive_verifier(b, ser.read_common_circuit_data(
        _inner_common()))
    return b.build(device="cpu")


def test_keccak_outer_build_matches_jax(keccak_outer):
    from test_torch_recursion import assert_common_equal

    read = ser.read_common_circuit_data(
        read_bin("recursive_keccak_gl_2e6_common"))
    assert_common_equal(read, keccak_outer.common)
    assert keccak_outer.common.degree_bits == 12
    assert keccak_outer.verifier_only == ser.read_verifier_only_circuit_data(
        read_bin("recursive_keccak_gl_2e6_verifier"), hasher=keccak_hasher)


# --------------------------------------------------------------------------
# (c) refusals
# --------------------------------------------------------------------------


def test_keccak_over_babybear_is_refused():
    with pytest.raises(ValueError, match="babybear"):
        CircuitBuilder(CircuitConfig.standard_recursion_config_bb(),
                       host.BABYBEAR, hasher=keccak_hasher)


def test_keccak_in_a_hashing_gadget_is_refused():
    b = _port_builder()
    x = b.add_virtual_target()
    for call in (lambda: b.hash_n_to_hash_no_pad([x] * 9,
                                                 hasher=keccak_hasher),
                 lambda: b.permute([x] * 12, hasher=keccak_hasher)):
        with pytest.raises(ValueError, match="not algebraic"):
            call()
    # the default gadget hasher is the inner Poseidon, under Keccak too
    b.hash_n_to_hash_no_pad([x] * 9)
    assert any(i.gate.id() == "PoseidonGate<WIDTH=12>"
               for i in b.gate_instances)


def test_recursive_verifier_over_a_keccak_inner_is_refused(small,
                                                           jax_bytes):
    data = small[0]
    b = CircuitBuilder(CircuitConfig.standard_recursion_config_gl())
    proof_t, vk_t = circuits.recursive_verifier(b, data.common)
    pw = PartialWitness()
    with pytest.raises(ValueError, match="byte digests"):
        rv.set_proof_with_pis_target(pw, proof_t, jax_bytes[2])
    with pytest.raises(ValueError, match="byte digests"):
        rv.set_verifier_data_target(pw, vk_t, data.verifier_only)


# --------------------------------------------------------------------------
# the fixtures' writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def write_fixtures() -> None:
    """With the JAX package on the CPU: the small circuit's build, its
    witness under ``set_nonrandom(True)`` and its sync proof (verified),
    with the JAX writers' bytes; the Keccak outer over the Poseidon outer
    of the 2^6 and of the 2^12 chain (build only)."""
    import time

    from test_torch_zk import _jax_setup

    _jax_setup()
    from plonky2_goldibear_tpu.field import fft as jfft
    from plonky2_goldibear_tpu.field import gl as jgl
    from plonky2_goldibear_tpu.hash import keccak_hasher as jkeccak
    from plonky2_goldibear_tpu.iop import generator as gen
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig
    from plonky2_goldibear_tpu.plonk.witness_transfer import WitnessTransfer
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv
    from plonky2_goldibear_tpu.utils.timing import ProvingProcessInfo

    t0 = time.time()

    def write_bins(prefix, data, proof=None):
        parts = [("common", jser.write_common_circuit_data(data.common)),
                 ("verifier", jser.write_verifier_only_circuit_data(
                     data.verifier_only, data.common.spec))]
        if proof is not None:
            parts.append(("proof", jser.write_proof_with_public_inputs(
                proof, data.common)))
        for part, blob in parts:
            with open(data_path(f"{prefix}_{part}.bin"), "wb") as f:
                f.write(blob)

    b = JCircuitBuilder(circuits.keccak_pow31_config(JCircuitConfig),
                        hasher=jkeccak)
    x = circuits.keccak_pow31(b)
    data = b.build()
    common, po = data.common, data.prover_only
    pw = JPartialWitness()
    pw.set_target(x, circuits.KECCAK_POW31_INPUT)
    gen.set_nonrandom(True)
    part = gen.generate_partial_witness(pw, po, common)
    counter = int(gen._NONRANDOM_COUNTER)
    wires = WitnessTransfer(jgl, part, po, common, dense=True).matrix
    gen.set_nonrandom(True)
    proof = data.prove(pw, timing=ProvingProcessInfo("prove"))
    proof_counter = int(gen._NONRANDOM_COUNTER)
    data.verify(proof)
    np.savez_compressed(
        data_path(POW31 + ".npz"),
        meta=np.array(json.dumps(circuit_meta(data, "goldilocks"))),
        constants_sigmas=np.asarray(jgl.to_ints(jfft.fft(
            jgl, po.constants_sigmas_commitment.coeffs)), dtype=np.uint64),
        wires=np.asarray(wires, dtype=np.uint64),
        public_inputs=np.asarray(part.get_targets(po.public_inputs),
                                 dtype=np.uint64),
        counter=np.asarray(counter, dtype=np.uint64),
        proof_counter=np.asarray(proof_counter, dtype=np.uint64))
    write_bins(POW31, data, proof)
    print(f"wrote {POW31} (2^{common.degree_bits} rows, PoW witness "
          f"{proof.proof.opening_proof.pow_witness}) after "
          f"{time.time() - t0:.0f} s", flush=True)

    for bits in (6, 12):
        with open(data_path(f"recursive_gl_2e{bits}inner_common.bin"),
                  "rb") as f:
            inner = jser.read_common_circuit_data(f.read())
        ob = JCircuitBuilder(JCircuitConfig.standard_recursion_config_gl(),
                             hasher=jkeccak)
        circuits.recursive_verifier(ob, inner, rv=jrv)
        outer = ob.build()
        write_bins(f"recursive_keccak_gl_2e{bits}", outer)
        print(f"wrote the Keccak outer over the 2^{bits} chain's outer "
              f"(2^{outer.common.degree_bits} rows) after "
              f"{time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the Keccak-config fixtures from the JAX package "
                    "(or, without --write-fixtures, run these tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    cli = ap.parse_args()
    if cli.write_fixtures:
        write_fixtures()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
