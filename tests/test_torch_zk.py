"""Zero knowledge in the port against the JAX package, on the CPU, exact
(tolerance zero: counts, rows, field values, caps, digests, witness
columns and proofs compared with equality).

(a) Live against JAX: ``_blinding_counts`` over FRI query rounds 1, 2, 6
    and 28 and several gate counts (the reference regression inner's
    (2774, 2776) among them), the blinding rows the builder lays out, and
    the salts and blinding values drawn from one rng in bulk against the
    per-element draws of the JAX package.
(b) Against the JAX fixture ``data/zk_fib_1q.npz``: ``circuits.zk_fib``
    under ``standard_recursion_zk_config_gl()`` cut to one FRI query round
    (2^8 rows): the port's build (common data, constants/sigmas, cap,
    digest), its witness with the blinding rows, and its proof, salts
    included, bit for bit under ``NonRandomRng``.  The proof verifies, a
    tampered copy is rejected, a proof from another rng differs in its
    wires cap and verifies; the port's reader reads the JAX writer's bytes
    of the circuit and the proof.
(c) The regression recursion of the reference (``circuits.regression_inner``
    and the recursive verifier over it, zk, 2^14 each) is built and proved
    on the card (``-m gpu``; ``chip_smoke.py`` does it too): its common
    data against the port's reading of ``tests/data/gl_regression_common.bin``,
    caps and digests against the JAX builds in
    ``data/zk_regression_*.bin``.

The fixtures are written by the JAX package on the CPU with

    python tests/test_torch_zk.py --write-fixtures [--regression]
"""

from __future__ import annotations

import copy
import json
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from plonky2_goldibear_torch import circuits  # noqa: E402
from plonky2_goldibear_torch.field import host  # noqa: E402
from plonky2_goldibear_torch.iop.generator import (  # noqa: E402
    NonRandomRng, rand_field_element, rand_field_elements)
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import (  # noqa: E402
    DATA_DIR, circuit_meta, read_fixture)
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.plonk.proof import flatten_proof  # noqa: E402
from plonky2_goldibear_torch.plonk.verifier import (  # noqa: E402
    VerificationError)

torch.set_num_threads(1)
SPEC = host.GOLDILOCKS
P = SPEC.p
ZK_PATH = os.path.join(DATA_DIR, "zk_fib_1q.npz")


def zk_config(config_cls, num_query_rounds: int):
    """``standard_recursion_zk_config_gl()`` of ``config_cls`` (the port's
    or the JAX package's) with ``num_query_rounds`` FRI query rounds."""
    c = config_cls.standard_recursion_zk_config_gl()
    return replace(c, fri_config=replace(c.fri_config,
                                         num_query_rounds=num_query_rounds))


def bin_path(name: str) -> str:
    return os.path.join(DATA_DIR, name + ".bin")


def read_bin(name: str) -> bytes:
    with open(bin_path(name), "rb") as f:
        return f.read()


# --------------------------------------------------------------------------
# (a) blinding counts, rows and bulk draws, live against JAX
# --------------------------------------------------------------------------


def _jax_builder(config):
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    return JCircuitBuilder(config)


def _jax_zk_config(q):
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig
    return zk_config(JCircuitConfig, q)


@pytest.mark.parametrize("num_query_rounds", [1, 2, 6, 28])
@pytest.mark.parametrize("num_noops", [0, 3, 200, 4000])
def test_blinding_counts_match_jax(num_query_rounds, num_noops):
    from plonky2_goldibear_tpu.gates.basic_gates import NoopGate as JNoop

    from plonky2_goldibear_torch.gates.basic_gates import NoopGate

    port = CircuitBuilder(zk_config(CircuitConfig, num_query_rounds))
    jax_ = _jax_builder(_jax_zk_config(num_query_rounds))
    for _ in range(num_noops):
        port.add_gate(NoopGate(), [])
        jax_.add_gate(JNoop(), [])
    assert port._blinding_counts() == jax_._blinding_counts()
    if num_query_rounds == 28 and num_noops == 4000:
        assert port._blinding_counts() == (2774, 2776)


def test_blinding_rows_match_jax():
    """The rows, copies and generators ``_blind`` adds (1 query round)."""
    port = CircuitBuilder(zk_config(CircuitConfig, 1))
    jax_ = _jax_builder(_jax_zk_config(1))
    for b in (port, jax_):
        circuits.zk_fib(b)
        b._blind()
    assert [i.gate.id() for i in port.gate_instances] == \
        [i.gate.id() for i in jax_.gate_instances]
    assert port.copy_constraints == jax_.copy_constraints
    assert [(type(g).__name__, getattr(g, "row", None),
             list(getattr(g, "wires", []))) for g in port.generators] == \
        [(type(g).__name__, getattr(g, "row", None),
          list(getattr(g, "wires", []))) for g in jax_.generators]


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_bulk_draws_equal_one_by_one(field, n):
    """``rand_field_elements`` (the salts' and blinding rows' bulk draw)
    gives the per-element sequence of ``rand_field_element``, and that of
    the JAX package's draw, from the same counter or numpy seed."""
    from plonky2_goldibear_tpu.iop import generator as jgen

    p = host.GOLDILOCKS.p if field == "goldilocks" else host.BABYBEAR.p
    for start in (1, 5, (1 << 64) - 3):
        a, b = NonRandomRng(start), NonRandomRng(start)
        bulk = [int(v) for v in rand_field_elements(p, a, n)]
        assert bulk == [rand_field_element(p, b) for _ in range(n)]
        assert a.counter == b.counter
        jgen._NONRANDOM_COUNTER = start
        try:
            assert bulk == [jgen.rand_field_element(p) for _ in range(n)]
        finally:
            jgen.set_nonrandom(False)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    bulk = [int(v) for v in rand_field_elements(p, a, n)]
    assert bulk == [rand_field_element(p, b) for _ in range(n)]
    jgen.seed_randomness(7)
    assert bulk == [jgen.rand_field_element(p) for _ in range(n)]


def test_rejected_counter_draws_are_skipped():
    """A counter value whose product lands above the zone is rejected and
    the next one taken, as the JAX package's one-by-one draw does
    (Goldilocks: v * p mod 2^64 >= p for v near a multiple of 2^64 / p)."""
    from plonky2_goldibear_tpu.iop import generator as jgen

    p = P
    v = next(v for v in range((1 << 32) - 4, (1 << 32) + 64)
             if (v * p) & ((1 << 64) - 1) > p - 1)
    a = NonRandomRng(v - 3)
    bulk = [int(x) for x in rand_field_elements(p, a, 6)]
    jgen._NONRANDOM_COUNTER = v - 3
    try:
        assert bulk == [jgen.rand_field_element(p) for _ in range(6)]
        # seven counter values for six draws: one was rejected
        assert a.counter == jgen._NONRANDOM_COUNTER == v + 4
    finally:
        jgen.set_nonrandom(False)


# --------------------------------------------------------------------------
# (b) the 1-round zk circuit against the JAX fixture
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zk_fib():
    """(data, inputs, arrays, meta, proof from NonRandomRng(1), counter
    after the proof), built and proved by the port on the CPU."""
    b = CircuitBuilder(zk_config(CircuitConfig, 1))
    ins = circuits.zk_fib(b)
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_targets(ins, circuits.ZK_FIB_INPUTS)
    rng = NonRandomRng(1)
    proof = data.prove(pw, rng=rng)
    arrays, meta = read_fixture(ZK_PATH)
    return data, pw, arrays, meta, proof, rng.counter


def test_zk_build_matches_jax(zk_fib):
    data, _, arrays, meta, _, _ = zk_fib
    assert data.common.config.zero_knowledge
    assert data.common.fri_params.hiding
    assert data.common.degree_bits == 8
    assert circuit_meta(data, "goldilocks") == meta
    np.testing.assert_array_equal(
        data.F.to_ints(data.prover_only.constants_sigmas_values),
        arrays["constants_sigmas"])
    np.testing.assert_array_equal(
        np.asarray(data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        arrays["constants_sigmas_cap"])


def test_zk_witness_with_blinding_rows_matches_jax(zk_fib):
    data, pw, arrays, _, _, _ = zk_fib
    rng = NonRandomRng(1)
    circuit = data.circuit(pw, rng)
    np.testing.assert_array_equal(circuit.F.to_ints(circuit.wires),
                                  arrays["wires"])
    assert circuit.public_inputs == [int(v) for v in arrays["public_inputs"]]
    assert rng.counter == int(arrays["counter"])
    # the blinding rows are random: 65 rows of every wire and 2 x 67 rows
    # of the routed wires at one round
    assert np.count_nonzero(arrays["wires"]) > 65 * 135 + 134 * 80 - 100


def test_zk_proof_matches_jax_bit_for_bit(zk_fib):
    _, _, arrays, _, proof, counter = zk_fib
    flat = flatten_proof(proof)
    differ = [k for k, v in flat.items()
              if not np.array_equal(v, arrays["proof_" + k])]
    assert not differ, f"proof phases {differ} differ from the JAX proof"
    assert counter == int(arrays["proof_counter"])


def test_zk_proof_verifies_and_tampered_copy_is_rejected(zk_fib):
    data, _, _, _, proof, _ = zk_fib
    data.verify(proof)
    bad = copy.deepcopy(proof)
    leaf = bad.proof.opening_proof.query_round_proofs[0]\
        .initial_trees_proof.evals_proofs[1][0]
    leaf[-1] = (leaf[-1] + 1) % P      # a salt of the wires leaf
    with pytest.raises(VerificationError):
        data.verify(bad)
    bad = copy.deepcopy(proof)
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % P
    with pytest.raises(VerificationError):
        data.verify(bad)


def test_zk_proofs_from_other_rngs_differ_and_verify(zk_fib):
    data, pw, _, _, proof, _ = zk_fib
    # a seed whose proof-of-work search is short on one CPU thread
    other = data.prove(pw, rng=np.random.default_rng(7))
    assert other.proof.wires_cap != proof.proof.wires_cap
    assert other.public_inputs == proof.public_inputs
    data.verify(other)


def test_loaded_zk_circuit_proves_as_jax():
    """The fixture carried across as data (``load_circuit``: the config
    hides, so does the proof) and proved from the counter its witness
    generation left: the JAX proof, salts included."""
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk.circuit_data import load_circuit

    arrays, meta = read_fixture(ZK_PATH)
    circuit = load_circuit(arrays, meta, device="cpu")
    assert circuit.common.fri_params.hiding
    rng = NonRandomRng(int(arrays["counter"]))
    flat = flatten_proof(prover.prove(circuit, device="cpu", rng=rng))
    for k, v in flat.items():
        np.testing.assert_array_equal(v, arrays["proof_" + k], err_msg=k)
    assert rng.counter == int(arrays["proof_counter"])


def test_reader_reads_the_jax_zk_bytes(zk_fib):
    data, _, _, _, proof, _ = zk_fib
    common = ser.read_common_circuit_data(read_bin("zk_fib_1q_common"))
    assert common.config == data.common.config
    assert common.fri_params == data.common.fri_params
    vk = ser.read_verifier_only_circuit_data(read_bin("zk_fib_1q_verifier"))
    assert vk == data.verifier_only
    read = ser.read_proof_with_public_inputs(read_bin("zk_fib_1q_proof"),
                                             common)
    assert flatten_proof(read).keys() == flatten_proof(proof).keys()
    for k, v in flatten_proof(read).items():
        np.testing.assert_array_equal(v, flatten_proof(proof)[k], err_msg=k)


# --------------------------------------------------------------------------
# (c) the regression recursion, zk, 2^14: on the card
# --------------------------------------------------------------------------


def test_regression_outer_matches_jax_before_build():
    """The recursive verifier over the regression inner (zk, 2^14; its
    common data as the JAX build wrote it) laid out by both builders: rows,
    copies, constants and slots, before ``build``."""
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    blob = read_bin("zk_regression_inner_common")
    common = ser.read_common_circuit_data(blob)
    assert common.config.zero_knowledge and common.fri_params.hiding
    assert common.degree_bits == 14
    port = CircuitBuilder(CircuitConfig.standard_recursion_zk_config_gl())
    jax_ = _jax_builder(_jax_zk_config(28))
    circuits.recursive_verifier(port, common, public_inputs=False)
    circuits.recursive_verifier(jax_, jser.read_common_circuit_data(blob),
                                rv=jrv, public_inputs=False)
    assert [(i.gate.id(), i.constants) for i in port.gate_instances] == \
        [(i.gate.id(), i.constants) for i in jax_.gate_instances]
    assert port.copy_constraints == jax_.copy_constraints
    assert port.current_slots == jax_.current_slots
    assert port.public_inputs == jax_.public_inputs == []
    assert port._blinding_counts() == jax_._blinding_counts()


@pytest.mark.gpu
def test_regression_recursion_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the 2^14 zk commits and proves")
    from plonky2_goldibear_torch.gates.basic_gates import NoopGate
    from plonky2_goldibear_torch.gates.poseidon import PoseidonGate
    from plonky2_goldibear_torch.recursion import recursive_verifier as rv

    config = CircuitConfig.standard_recursion_zk_config_gl()
    b = CircuitBuilder(config)
    circuits.regression_inner(b, NoopGate(), PoseidonGate())
    inner = b.build()
    assert inner.common.degree_bits == 14
    assert inner.verifier_only == ser.read_verifier_only_circuit_data(
        read_bin("zk_regression_inner_verifier"))
    inner_proof = inner.prove(PartialWitness(), rng=np.random.default_rng(1))
    inner.verify(inner_proof)

    ob = CircuitBuilder(config)
    proof_t, vk_t = circuits.recursive_verifier(ob, inner.common,
                                                public_inputs=False)
    outer = ob.build()
    read = ser.read_common_circuit_data(open(os.path.join(
        ROOT, "tests", "data", "gl_regression_common.bin"), "rb").read())
    assert_common_equal(read, outer.common)
    assert outer.verifier_only == ser.read_verifier_only_circuit_data(
        read_bin("zk_regression_outer_verifier"))
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, inner_proof)
    rv.set_verifier_data_target(pw, vk_t, inner.verifier_only)
    proofs = [outer.prove(pw, rng=np.random.default_rng(s)) for s in (2, 3)]
    for pr in proofs:
        outer.verify(pr)
    assert proofs[0].proof.wires_cap != proofs[1].proof.wires_cap
    bad = copy.deepcopy(proofs[0])
    bad.proof.openings.wires[7] = ((bad.proof.openings.wires[7][0] + 1) % P,
                                   bad.proof.openings.wires[7][1])
    with pytest.raises(VerificationError):
        outer.verify(bad)


def assert_common_equal(read, built):
    """Common data read from bytes equals a built circuit's, field by
    field."""
    assert read.config == built.config
    assert read.fri_params == built.fri_params
    assert [g.id() for g in read.gates] == [g.id() for g in built.gates]
    assert read.selectors_info.selector_indices == \
        built.selectors_info.selector_indices
    assert [tuple(g) for g in read.selectors_info.groups] == \
        [tuple(g) for g in built.selectors_info.groups]
    for name in ("quotient_degree_factor", "num_gate_constraints",
                 "num_constants", "num_public_inputs", "k_is",
                 "num_partial_products", "num_lookup_polys",
                 "num_lookup_selectors", "luts", "spec"):
        assert getattr(read, name) == getattr(built, name), name


# --------------------------------------------------------------------------
# the fixtures' writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def _jax_setup():
    # the first witness generation of a circuit runs the fixpoint; keep
    # every later one on it too, so each draws in the fixpoint's order
    os.environ["PLONKY2_TPU_DISABLE_WITGEN_NATIVE"] = "1"
    # the JAX lookup polys by its scalar host reference: its scan program
    # ran for over an hour on XLA:CPU (they are equal, and the port's
    # tests hold both against the port's)
    os.environ["PLONKY2_TPU_HOST_LOOKUPS"] = "1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if cache:
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def jax_prove_fixture(data, pw, path, bins=None, lookups=False,
                      field="goldilocks"):
    """With the JAX package: the witness of ``pw`` under
    ``set_nonrandom(True)`` (after ``set_lookup_wires`` for a lookup
    circuit), then the sync-transcript proof from the reset counter,
    verified; written to ``path`` with the circuit's data (over ``field``).
    ``bins``: a name prefix for the JAX writers' common data, verifier data
    and proof bytes.  Returns the proof."""
    import time

    from plonky2_goldibear_tpu.field import bb as jbb
    from plonky2_goldibear_tpu.field import fft as jfft
    from plonky2_goldibear_tpu.field import gl as jgl
    from plonky2_goldibear_tpu.iop import generator as gen
    from plonky2_goldibear_tpu.plonk import prover as jprover
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.plonk.witness_transfer import WitnessTransfer
    from plonky2_goldibear_tpu.utils.timing import ProvingProcessInfo

    t0 = time.time()
    jF = jgl if field == "goldilocks" else jbb
    common, po = data.common, data.prover_only
    gen.set_nonrandom(True)
    part = gen.generate_partial_witness(pw, po, common)
    counter = int(gen._NONRANDOM_COUNTER)
    if lookups:
        jprover.set_lookup_wires(po, common, part)
    wires = WitnessTransfer(jF, part, po, common, dense=True).matrix
    public_inputs = part.get_targets(po.public_inputs)
    arrays = {
        "constants_sigmas": np.asarray(jF.to_ints(jfft.fft(
            jF, po.constants_sigmas_commitment.coeffs)), dtype=np.uint64),
        "constants_sigmas_cap": np.asarray(
            data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        "wires": np.asarray(wires, dtype=np.uint64),
        "public_inputs": np.asarray(public_inputs, dtype=np.uint64),
        "counter": np.asarray(counter, dtype=np.uint64),
    }
    gen.set_nonrandom(True)
    proof = data.prove(pw, timing=ProvingProcessInfo("prove"))
    arrays["proof_counter"] = np.asarray(int(gen._NONRANDOM_COUNTER),
                                         dtype=np.uint64)
    data.verify(proof)
    for k, v in flatten_proof(proof).items():
        arrays["proof_" + k] = v
    np.savez_compressed(path, meta=np.array(json.dumps(
        circuit_meta(data, field))), **arrays)
    if bins:
        for part_name, blob in (
                ("common", jser.write_common_circuit_data(common)),
                ("verifier", jser.write_verifier_only_circuit_data(
                    data.verifier_only, common.spec)),
                ("proof", jser.write_proof_with_public_inputs(proof,
                                                              common))):
            with open(bin_path(f"{bins}_{part_name}"), "wb") as f:
                f.write(blob)
    print(f"wrote {path} after {time.time() - t0:.0f} s", flush=True)
    return proof


def write_fixtures() -> None:
    """The 1-round zk circuit: build, witness, proof (JAX sync prover
    under ``set_nonrandom(True)``) and its bytes."""
    _jax_setup()
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness

    b = _jax_builder(_jax_zk_config(1))
    ins = circuits.zk_fib(b)
    data = b.build()
    assert data.common.degree_bits == 8, data.common.degree_bits
    pw = JPartialWitness()
    pw.set_targets(ins, circuits.ZK_FIB_INPUTS)
    jax_prove_fixture(data, pw, ZK_PATH, bins="zk_fib_1q")


def write_regression_fixtures() -> None:
    """The JAX builds of the regression inner and of the recursive
    verifier over it (zk, 2^14 each): the inner's common and verifier
    data, the outer's verifier data; the outer's common data is checked
    against ``tests/data/gl_regression_common.bin`` here."""
    import time

    _jax_setup()
    from plonky2_goldibear_tpu.gates.basic_gates import NoopGate as JNoop
    from plonky2_goldibear_tpu.gates.poseidon import \
        PoseidonGate as JPoseidon
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    t0 = time.time()
    config = JCircuitConfig.standard_recursion_zk_config_gl()
    b = _jax_builder(config)
    circuits.regression_inner(b, JNoop(), JPoseidon())
    inner = b.build()
    assert inner.common.degree_bits == 14
    print(f"inner built after {time.time() - t0:.0f} s", flush=True)
    ob = _jax_builder(config)
    circuits.recursive_verifier(ob, inner.common, rv=jrv,
                                public_inputs=False)
    outer = ob.build()
    print(f"outer built after {time.time() - t0:.0f} s", flush=True)
    outer_common = jser.write_common_circuit_data(outer.common)
    with open(os.path.join(ROOT, "tests", "data",
                           "gl_regression_common.bin"), "rb") as f:
        same = f.read() == outer_common
    print(f"JAX outer common data equals the reference's: {same}",
          flush=True)
    for name, blob in (
            ("zk_regression_inner_common",
             jser.write_common_circuit_data(inner.common)),
            ("zk_regression_inner_verifier",
             jser.write_verifier_only_circuit_data(inner.verifier_only)),
            ("zk_regression_outer_verifier",
             jser.write_verifier_only_circuit_data(outer.verifier_only))):
        with open(bin_path(name), "wb") as f:
            f.write(blob)
    print(f"wrote the regression fixtures after {time.time() - t0:.0f} s",
          flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the zk fixtures from the JAX package (or, "
                    "without --write-fixtures, run these tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    ap.add_argument("--regression", action="store_true",
                    help="the 2^14 regression builds instead")
    cli = ap.parse_args()
    if cli.write_fixtures:
        if cli.regression:
            write_regression_fixtures()
        else:
            write_fixtures()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
