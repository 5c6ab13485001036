"""The port's prover as a whole against the JAX prover, on a committed
fixture.

The fixture holds an arithmetic-chain circuit built by the JAX package
(constants/sigmas values, the full wire matrix, the circuit metadata) and
the JAX proof of it under ``set_nonrandom(True)``.  The port loads the
circuit as data, recommits the constants/sigmas, proves on the CPU and must
reproduce every phase of the JAX proof bit for bit.

Regenerate the fixtures with the JAX package on the CPU.  The Goldilocks
2^6 one takes about a quarter of an hour; the 2^12 one about three hours
even without the device-transcript comparison, nearly all of it in the JAX
PoseidonGate quotient program on XLA:CPU:

    python tests/test_torch_prove.py --write-fixtures 6
    python tests/test_torch_prove.py --write-fixtures --sync-only 12
    python tests/test_torch_prove.py --write-fixtures --field babybear 6
    python tests/test_torch_prove.py --write-fixtures --field babybear \
        --sync-only 12

``--retry`` writes the 2^6 circuit's retry companion instead
(``tests/test_torch_retry.py`` reads it):

    python tests/test_torch_prove.py --write-fixtures --retry 6
    python tests/test_torch_prove.py --write-fixtures --retry \
        --field babybear 6
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from plonky2_goldibear_torch.plonk.proof import PROOF_PHASES  # noqa: E402

FIXTURE_SIZES = (6, 12)


# --------------------------------------------------------------------------
# the port against the committed 2^6 fixture (CPU)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proved():
    """(circuit, arrays, flattened port proof) of each field's 2^6 fixture,
    proved on the CPU once per module."""
    import torch

    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk.circuit_data import load_fixture
    from plonky2_goldibear_torch.plonk.proof import flatten_proof

    torch.set_num_threads(1)
    cache = {}

    def get(field):
        if field not in cache:
            circuit, arrays = load_fixture(6, device="cpu", field=field)
            proof = prover.prove(circuit, device="cpu")
            cache[field] = (circuit, arrays, flatten_proof(proof))
        return cache[field]

    return get


def _cap_matches(proved, field):
    circuit, arrays, _ = proved(field)
    np.testing.assert_array_equal(
        np.asarray(circuit.constants_sigmas_cap(), dtype=np.uint64),
        arrays["constants_sigmas_cap"])


def test_constants_sigmas_cap_matches_jax(proved):
    _cap_matches(proved, "goldilocks")


def test_bb_constants_sigmas_cap_matches_jax(proved):
    """BabyBear: 8-element digests of Poseidon2 over Montgomery values."""
    _cap_matches(proved, "babybear")


@pytest.mark.parametrize("field,phase", [
    pytest.param("goldilocks", ph, id=ph) for ph in PROOF_PHASES] + [
    pytest.param("babybear", ph, id="bb-" + ph) for ph in PROOF_PHASES])
def test_proof_phase_matches_jax(proved, field, phase):
    _, arrays, flat = proved(field)
    np.testing.assert_array_equal(flat[phase], arrays["proof_" + phase])


@pytest.mark.parametrize("field,preset", [
    ("goldilocks", "standard_recursion_config_gl"),
    ("babybear", "standard_recursion_config_bb")])
def test_fixture_config_is_the_preset(field, preset):
    """Each fixture was built under its field's standard recursion config;
    the BabyBear one has FRI arity 2^3, Poseidon2 and the 167/41 wires."""
    from plonky2_goldibear_torch.plonk.circuit_data import (fixture_path,
                                                            load_circuit,
                                                            read_fixture)
    from plonky2_goldibear_torch.plonk.config import CircuitConfig

    arrays, meta = read_fixture(fixture_path(6, field))
    circuit = load_circuit(arrays, meta, device="cpu")
    assert circuit.common.config == getattr(CircuitConfig, preset)()
    assert circuit.common.spec.name == field
    assert circuit.hasher.NUM_HASH_OUT == circuit.common.spec.num_hash_out_elts
    arity_bits = set(meta["reduction_arity_bits"])
    assert arity_bits == ({4} if field == "goldilocks" else {3})


def test_port_imports_no_jax():
    """Every module of the port (both fields'), and chip_smoke.py, imports
    neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import plonky2_goldibear_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('plonky2_goldibear_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith("
        "'plonky2_goldibear_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30


def test_prove_without_device_needs_a_gpu():
    import torch

    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk.circuit_data import (load_circuit,
                                                            read_fixture,
                                                            fixture_path)

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    arrays, meta = read_fixture(fixture_path(6))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_circuit(arrays, meta)
    circuit = load_circuit(arrays, meta, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prover.prove(circuit)


def test_load_circuit_rejects_unported_gate():
    from plonky2_goldibear_torch.plonk.circuit_data import (load_circuit,
                                                            read_fixture,
                                                            fixture_path)

    arrays, meta = read_fixture(fixture_path(6))
    meta = dict(meta, gates=meta["gates"] + ["LookupGate { num_slots: 26 }"])
    with pytest.raises(ValueError, match="not ported"):
        load_circuit(arrays, meta, device="cpu")


# --------------------------------------------------------------------------
# fixture writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def _build_arith_chain(config, target_degree_bits, spec=None):
    """The JAX package's build of ``circuits.arith_chain``: one public
    input, a chain of x*x + x ops filling 2^target_degree_bits rows less a
    few for the public-input hash, constants and padding."""
    from plonky2_goldibear_tpu.plonk.builder import CircuitBuilder

    from plonky2_goldibear_torch.circuits import arith_chain

    builder = (CircuitBuilder(config) if spec is None
               else CircuitBuilder(config, spec=spec))
    x = arith_chain(builder, target_degree_bits)
    data = builder.build()
    assert data.common.degree_bits == target_degree_bits, \
        data.common.degree_bits
    return data, x


def write_fixture(degree_bits: int, path: str,
                  compare_async: bool = True,
                  field: str = "goldilocks") -> None:
    """Build the circuit, export its data and witness, prove it on the JAX
    sync-transcript path (the one the port mirrors), verify, and write the
    fixture.  Then, unless ``compare_async`` is off, prove again on the
    JAX device-transcript path and report any field that differs.
    ``field`` is "goldilocks" (``standard_recursion_config_gl``, Poseidon)
    or "babybear" (``standard_recursion_config_bb``, Poseidon2)."""
    import time

    from plonky2_goldibear_tpu.field import bb as jbb
    from plonky2_goldibear_tpu.field import fft as jfft
    from plonky2_goldibear_tpu.field import gl as jgl
    from plonky2_goldibear_tpu.field.host import BABYBEAR
    from plonky2_goldibear_tpu.hash import poseidon2_bb, poseidon_gl
    from plonky2_goldibear_tpu.iop import generator as gen
    from plonky2_goldibear_tpu.iop.witness import PartialWitness
    from plonky2_goldibear_tpu.plonk.config import CircuitConfig
    from plonky2_goldibear_tpu.plonk.verifier import verify
    from plonky2_goldibear_tpu.plonk.witness_transfer import WitnessTransfer
    from plonky2_goldibear_tpu.utils.timing import ProvingProcessInfo

    from plonky2_goldibear_torch.plonk.circuit_data import circuit_meta
    from plonky2_goldibear_torch.plonk.proof import flatten_proof

    t0 = time.time()
    gen.set_nonrandom(True)
    if field == "babybear":
        jF, hasher = jbb, poseidon2_bb
        data, x = _build_arith_chain(
            CircuitConfig.standard_recursion_config_bb(), degree_bits,
            spec=BABYBEAR)
    else:
        jF, hasher = jgl, poseidon_gl
        data, x = _build_arith_chain(
            CircuitConfig.standard_recursion_config_gl(), degree_bits)
    common, po = data.common, data.prover_only
    pw = PartialWitness()
    pw.set_target(x, 3)

    gen.set_nonrandom(True)
    part = gen.generate_partial_witness(pw, po, common)
    public_inputs = part.get_targets(po.public_inputs)
    wires = WitnessTransfer(jF, part, po, common, dense=True).matrix
    cs_values = jF.to_ints(jfft.fft(
        jF, po.constants_sigmas_commitment.coeffs))

    arrays = {
        "constants_sigmas": np.asarray(cs_values, dtype=np.uint64),
        "wires": np.asarray(wires, dtype=np.uint64),
        "public_inputs": np.asarray(public_inputs, dtype=np.uint64),
        "constants_sigmas_cap": np.asarray(
            data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
    }
    gen.set_nonrandom(True)
    proof_sync = data.prove(pw, timing=ProvingProcessInfo("prove"))
    verify(proof_sync, data.verifier_only, common, hasher=hasher)
    flat_sync = flatten_proof(proof_sync)
    assert [int(v) for v in flat_sync["public_inputs"]] == \
        [int(v) for v in public_inputs]
    for k, v in flat_sync.items():
        arrays["proof_" + k] = v
    meta = json.dumps(circuit_meta(data, field))
    np.savez_compressed(path, meta=np.array(meta), **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes) after "
          f"{time.time() - t0:.0f} s", flush=True)

    if compare_async:
        gen.set_nonrandom(True)
        proof_async = data.prove(pw)
        verify(proof_async, data.verifier_only, common, hasher=hasher)
        flat_async = flatten_proof(proof_async)
        differ = [k for k in flat_sync
                  if not np.array_equal(flat_sync[k], flat_async[k])]
        print(f"2^{degree_bits}: JAX sync and device-transcript proofs "
              + (f"differ in {differ}" if differ else "are equal"),
              flush=True)


# attempts the retry fixture's prove makes fail before the one that proves:
# a BabyBear counter draw maps two neighbouring counters to one value, so
# the first redraw of the 2^6 circuit gives the wire its old value again
RETRY_FAILURES = 2


def write_retry_fixture(degree_bits: int, path: str,
                        field: str = "goldilocks") -> None:
    """Prove the fixture circuit with the JAX sync prover once more, its
    first RETRY_FAILURES attempts made to fail with ``InvZeroPermArg``, so
    that the JAX retry loop redraws the random wire (``rand_field_element``
    under ``set_nonrandom``) before each new attempt.  The file holds the
    nonrandom counter at the first failed attempt, the redrawn values and
    the flattened retry proof, checked by the JAX verifier and different
    from the fixture's own proof; the circuit is that of
    ``fixture_path(degree_bits, field)``."""
    import time

    from plonky2_goldibear_tpu.field import bb as jbb
    from plonky2_goldibear_tpu.field import gl as jgl
    from plonky2_goldibear_tpu.field.host import BABYBEAR
    from plonky2_goldibear_tpu.hash import poseidon2_bb, poseidon_gl
    from plonky2_goldibear_tpu.iop import generator as gen
    from plonky2_goldibear_tpu.iop.witness import PartialWitness
    from plonky2_goldibear_tpu.plonk import prover as jprover
    from plonky2_goldibear_tpu.plonk.config import CircuitConfig
    from plonky2_goldibear_tpu.plonk.verifier import verify
    from plonky2_goldibear_tpu.utils.timing import ProvingProcessInfo

    from plonky2_goldibear_torch.plonk.circuit_data import (circuit_meta,
                                                            fixture_path,
                                                            read_fixture)
    from plonky2_goldibear_torch.plonk.proof import flatten_proof

    t0 = time.time()
    gen.set_nonrandom(True)
    if field == "babybear":
        jF, hasher = jbb, poseidon2_bb
        data, x = _build_arith_chain(
            CircuitConfig.standard_recursion_config_bb(), degree_bits,
            spec=BABYBEAR)
    else:
        jF, hasher = jgl, poseidon_gl
        data, x = _build_arith_chain(
            CircuitConfig.standard_recursion_config_gl(), degree_bits)
    base, base_meta = read_fixture(fixture_path(degree_bits, field))
    meta = circuit_meta(data, field)
    assert meta["circuit_digest"] == base_meta["circuit_digest"], \
        "the circuit differs from the committed fixture's"
    pw = PartialWitness()
    pw.set_target(x, 3)

    real_prove, real_draw = jprover._internal_prove, \
        jprover.rand_field_element
    seen = {"attempts": 0, "values": []}

    def internal_prove(prover_data, common, wires_values, *args, **kw):
        seen["attempts"] += 1
        if seen["attempts"] == 1:
            seen["counter"] = gen._NONRANDOM_COUNTER
        if seen["attempts"] <= RETRY_FAILURES:
            raise jprover.InvZeroPermArg()
        row, col = prover_data.random_wire
        seen["wire"] = int(jF.to_ints(wires_values)[col, row])
        return real_prove(prover_data, common, wires_values, *args, **kw)

    def draw(p):
        seen["values"].append(real_draw(p))
        return seen["values"][-1]

    jprover._internal_prove, jprover.rand_field_element = \
        internal_prove, draw
    try:
        gen.set_nonrandom(True)
        proof = data.prove(pw, timing=ProvingProcessInfo("prove"))
    finally:
        jprover._internal_prove, jprover.rand_field_element = \
            real_prove, real_draw
    verify(proof, data.verifier_only, data.common, hasher=hasher)
    values = seen["values"]
    assert len(values) == RETRY_FAILURES and seen["wire"] == values[-1]
    flat = flatten_proof(proof)
    assert any(not np.array_equal(v, base["proof_" + k])
               for k, v in flat.items()), "the retry proved the same proof"
    arrays = {"counter": np.asarray(seen["counter"], dtype=np.uint64),
              "values": np.asarray(values, dtype=np.uint64)}
    for k, v in flat.items():
        arrays["proof_" + k] = v
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes) after "
          f"{time.time() - t0:.0f} s: counter {seen['counter']}, "
          f"values {values}", flush=True)


def _write_fixtures(args) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if cache:
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    from plonky2_goldibear_torch.plonk.circuit_data import fixture_path

    for bits in args.sizes or FIXTURE_SIZES:
        if args.retry:
            write_retry_fixture(bits, fixture_path(bits, args.field, True),
                                args.field)
        else:
            write_fixture(bits, fixture_path(bits, args.field),
                          not args.sync_only, args.field)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the port's prover fixtures from the JAX package "
                    "(or, without --write-fixtures, run these tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    ap.add_argument("--field", choices=("goldilocks", "babybear"),
                    default="goldilocks")
    ap.add_argument("--sync-only", action="store_true",
                    help="skip the device-transcript comparison prove")
    ap.add_argument("--retry", action="store_true",
                    help="write the retry companion of each size instead")
    ap.add_argument("sizes", nargs="*", type=int,
                    help="log2 rows (default: 6 12)")
    cli = ap.parse_args()
    if cli.write_fixtures:
        _write_fixtures(cli)
    else:
        sys.exit(pytest.main([__file__, "-q"]))
