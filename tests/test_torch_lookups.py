"""Lookups (logUp over u16 tables) in the port against the JAX package, on
the CPU, exact (tolerance zero: rows, selectors, field values, caps,
digests, lookup columns and proofs compared with equality).

(a) Live against JAX: the two lookup gates' ids, generators and
    ``eval_unfiltered``; ``selectors_lookup`` and
    ``selector_ends_lookups``; ``get_lut_re_evals``; the builder's lookup
    rows before ``build``; ``compute_lookup_polys_host`` on one witness
    and set of deltas, with the port's torch ``compute_lookup_polys`` equal
    to both; the builder's refusals of an unknown or unused table.
(b) Against the JAX fixtures ``data/lookup_tip5.npz`` and
    ``data/lookup_two_tables.npz``: the Tip5-16 single-table and two-table
    circuits (``circuits.tip5_lookups``, ``circuits.two_tables``) built,
    witnessed and proved by the port, bit for bit under ``NonRandomRng``;
    each proof verifies and a tampered output is rejected; the port's
    reader on the JAX writer's bytes of the Tip5-16 circuit and proof.
(c) Recursion over the Tip5-16 inner and the 2^16-entry table
    (``circuits.u16_table``, 2^12 rows) are checked in
    ``tests/test_torch_lookup_recursion.py`` and on the card.

The fixtures are written by the JAX package on the CPU with

    python tests/test_torch_lookups.py --write-fixtures [--only NAME]
"""

from __future__ import annotations

import copy
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from plonky2_goldibear_torch import circuits  # noqa: E402
from plonky2_goldibear_torch.field import gl, host  # noqa: E402
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
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
# circuit name -> (circuit function, witness inputs)
CIRCUITS = {
    "tip5": (circuits.tip5_lookups, circuits.TIP5_INPUTS),
    "two_tables": (circuits.two_tables, circuits.TWO_TABLE_INPUTS),
}


def npz_path(name: str) -> str:
    return os.path.join(DATA_DIR, f"lookup_{name}.npz")


def bin_path(name: str) -> str:
    return os.path.join(DATA_DIR, f"lookup_{name}.bin")


def read_bin(name: str) -> bytes:
    with open(bin_path(name), "rb") as f:
        return f.read()


def column_digests(wires: np.ndarray) -> np.ndarray:
    """A SHA-256 of each wire column (num_wires, 32) uint8."""
    return np.stack([np.frombuffer(hashlib.sha256(
        np.ascontiguousarray(col, dtype=np.uint64).tobytes()).digest(),
        dtype=np.uint8) for col in wires])


def _jax_builder():
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig
    return JCircuitBuilder(JCircuitConfig.standard_recursion_config_gl())


def _port_builder():
    return CircuitBuilder(CircuitConfig.standard_recursion_config_gl())


# --------------------------------------------------------------------------
# (a) the lookup modules, live against JAX
# --------------------------------------------------------------------------


def _tables():
    return [tuple((i, circuits.TIP5_16[i]) for i in range(16)),
            tuple((i, circuits.two_table_fn(i)) for i in range(16)),
            tuple((i, i * 7 % 16) for i in range(13))]


@pytest.mark.parametrize("table", range(3))
def test_lookup_gates_match_jax(table):
    """Ids (with the table's Keccak hash), generators and (empty)
    constraints of both lookup gates."""
    from plonky2_goldibear_tpu.gates import lookup_gates as jlg
    from plonky2_goldibear_tpu.iop.witness import \
        PartitionWitness as JPartitionWitness

    from plonky2_goldibear_torch.gates import lookup_gates as lg
    from plonky2_goldibear_torch.iop.witness import PartitionWitness

    lut = _tables()[table]
    pairs = [(lg.LookupGate(40, lut), jlg.LookupGate(40, lut)),
             (lg.LookupTableGate(26, lut, 5),
              jlg.LookupTableGate(26, lut, 5))]
    rng = np.random.default_rng(table)
    for port, jax_ in pairs:
        assert port.id() == jax_.id()
        assert port.num_wires() == jax_.num_wires()
        assert port.eval_unfiltered(None, None) == \
            jax_.eval_unfiltered(None, None) == []
        row = 5 if isinstance(port, lg.LookupTableGate) else 0
        inputs = {2 * s: int(rng.integers(0, len(lut))) for s in range(40)}
        outs = []
        for g, W in ((port, PartitionWitness), (jax_, JPartitionWitness)):
            w = W(80, 8, np.arange(8 * 80, dtype=np.int64))
            if isinstance(port, lg.LookupGate):
                for col, v in inputs.items():
                    w.set_target(("w", row, col), v)
            got = []
            for gen_ in g.generators(row, [], SPEC):
                buf = []
                assert gen_.run(w, buf)
                got.append(buf)
            outs.append(got)
        assert outs[0] == outs[1]


def test_lookup_selectors_match_jax():
    from plonky2_goldibear_tpu.gates import selectors as jsel

    from plonky2_goldibear_torch.gates import selectors as sel

    rows = [(1, 4, 9), (11, 12, 14), (16, 20, 30)]
    for f, jf in ((sel.selectors_lookup, jsel.selectors_lookup),
                  (sel.selector_ends_lookups, jsel.selector_ends_lookups)):
        got, want = f(64, rows), jf(64, rows)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _fake_common(luts, config=None):
    """What ``get_lut_re_evals`` reads of common data."""
    from types import SimpleNamespace
    return SimpleNamespace(
        spec=SPEC, luts=luts,
        config=config or CircuitConfig.standard_recursion_config_gl())


def test_get_lut_re_evals_match_jax():
    from plonky2_goldibear_tpu.plonk import vanishing as jvan

    from plonky2_goldibear_torch.plonk import vanishing as van

    common = _fake_common(_tables())
    rng = np.random.default_rng(3)
    deltas = [int(v) % P for v in rng.integers(0, 1 << 62, 8)]
    assert van.get_lut_re_evals(common, deltas) == \
        jvan.get_lut_re_evals(common, deltas)


def _port_build(name):
    fn, values = CIRCUITS[name]
    b = _port_builder()
    ins = fn(b)
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_targets(ins, values)
    return data, pw


@pytest.fixture(scope="module")
def built():
    """name -> (data, partial witness), built by the port on the CPU."""
    return {name: _port_build(name) for name in CIRCUITS}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_lookup_polys_match_jax_host_and_port_host(built, name):
    """The torch ``compute_lookup_polys`` against the port's and the JAX
    package's scalar references, on the circuit's witness, for several
    sets of deltas."""
    from types import SimpleNamespace

    from plonky2_goldibear_tpu.plonk import prover as jprover

    from plonky2_goldibear_torch.plonk import prover

    data, pw = built[name]
    circuit = data.circuit(pw, NonRandomRng(1))
    wires = gl.to_ints(circuit.wires)
    rows = data.prover_only.lookup_rows
    rng = np.random.default_rng(11)
    deltas = [int(v) % P for v in rng.integers(0, 1 << 62, 12)]
    want = []
    for i in range(0, 12, 4):
        host_ = prover.compute_lookup_polys_host(data.common, rows, wires,
                                                 deltas[i:i + 4])
        jax_ = jprover.compute_lookup_polys_host(
            data.common, SimpleNamespace(lookup_rows=rows), wires,
            deltas[i:i + 4])
        assert [[int(v) for v in r] for r in jax_] == host_
        np.testing.assert_array_equal(gl.to_ints(prover.compute_lookup_polys(
            gl, data.common, rows, circuit.wires, deltas[i:i + 4])),
            np.asarray(host_, np.uint64))
        want += host_
    # three challenges at once, as the prover sends them
    np.testing.assert_array_equal(gl.to_ints(prover.compute_lookup_polys(
        gl, data.common, rows, circuit.wires, deltas)),
        np.asarray(want, np.uint64))


def _both_rows(fn):
    port, jax_ = _port_builder(), _jax_builder()
    for b in (port, jax_):
        fn(b)
        b._add_all_lookups()
    return port, jax_


@pytest.mark.parametrize("name", list(CIRCUITS) + ["u16"])
def test_lookup_rows_match_jax_before_build(name):
    fn = circuits.u16_table if name == "u16" else CIRCUITS[name][0]
    port, jax_ = _both_rows(fn)
    assert [(i.gate.id(), i.constants) for i in port.gate_instances] == \
        [(i.gate.id(), i.constants) for i in jax_.gate_instances]
    assert port.copy_constraints == jax_.copy_constraints
    assert port.lookup_rows == jax_.lookup_rows
    assert port.current_slots == jax_.current_slots
    if name == "u16":
        assert port.lookup_rows == [(0, 113, 2633)]


def test_unknown_and_unused_tables_are_refused_as_by_jax():
    for b in (_port_builder(), _jax_builder()):
        t = b.add_virtual_target()
        with pytest.raises(AssertionError):
            b.add_lookup_from_index(t, 0)
    port, jax_ = _port_builder(), _jax_builder()
    for b in (port, jax_):
        b.add_lookup_table_from_table(list(range(16)),
                                      list(circuits.TIP5_16))
        b.register_public_input(b.add_virtual_target())
    with pytest.raises(AssertionError, match="unused"):
        port.build(device="cpu")
    with pytest.raises(AssertionError, match="unused"):
        jax_._add_all_lookups()


# --------------------------------------------------------------------------
# (b) the Tip5-16 and two-table circuits against the JAX fixtures
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proved(built):
    """name -> (proof from NonRandomRng(1), counter after it)."""
    out = {}
    for name, (data, pw) in built.items():
        rng = NonRandomRng(1)
        out[name] = (data.prove(pw, rng=rng), rng.counter)
    return out


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_build_matches_jax(built, name):
    data, _ = built[name]
    arrays, meta = read_fixture(npz_path(name))
    assert circuit_meta(data, "goldilocks") == meta
    np.testing.assert_array_equal(
        data.F.to_ints(data.prover_only.constants_sigmas_values),
        arrays["constants_sigmas"])
    np.testing.assert_array_equal(
        np.asarray(data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        arrays["constants_sigmas_cap"])


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_witness_matches_jax(built, name):
    data, pw = built[name]
    arrays, _ = read_fixture(npz_path(name))
    rng = NonRandomRng(1)
    circuit = data.circuit(pw, rng)
    np.testing.assert_array_equal(circuit.F.to_ints(circuit.wires),
                                  arrays["wires"])
    assert circuit.public_inputs == [int(v) for v in arrays["public_inputs"]]
    assert rng.counter == int(arrays["counter"])


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_proof_matches_jax_bit_for_bit(proved, name):
    proof, counter = proved[name]
    arrays, _ = read_fixture(npz_path(name))
    flat = flatten_proof(proof)
    differ = [k for k, v in flat.items()
              if not np.array_equal(v, arrays["proof_" + k])]
    assert not differ, f"proof phases {differ} differ from the JAX proof"
    assert counter == int(arrays["proof_counter"])


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_proof_verifies_and_tampered_output_is_rejected(built, proved, name):
    data, _ = built[name]
    proof, _ = proved[name]
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


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_loaded_lookup_circuit_proves_as_jax(name):
    """The fixture carried across as data (``load_circuit``: the tables
    and lookup rows from the metadata, the multiplicities in the wires)
    and proved: the JAX proof."""
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk.circuit_data import load_circuit

    arrays, meta = read_fixture(npz_path(name))
    circuit = load_circuit(arrays, meta, device="cpu")
    assert circuit.common.luts and circuit.lookup_rows
    flat = flatten_proof(prover.prove(circuit, device="cpu",
                                      rng=NonRandomRng(1)))
    for k, v in flat.items():
        np.testing.assert_array_equal(v, arrays["proof_" + k], err_msg=k)


def test_reader_reads_the_jax_lookup_bytes(built, proved):
    data, _ = built["tip5"]
    common = ser.read_common_circuit_data(read_bin("tip5_common"))
    assert common.luts == data.common.luts
    assert [g.id() for g in common.gates] == [g.id() for g in
                                              data.common.gates]
    for name in ("num_lookup_polys", "num_lookup_selectors",
                 "num_constants", "num_gate_constraints", "config",
                 "fri_params"):
        assert getattr(common, name) == getattr(data.common, name), name
    assert ser.read_verifier_only_circuit_data(read_bin("tip5_verifier")) \
        == data.verifier_only
    read = ser.read_proof_with_public_inputs(read_bin("tip5_proof"), common)
    flat = flatten_proof(proved["tip5"][0])
    for k, v in flatten_proof(read).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    data.verify(read)


# --------------------------------------------------------------------------
# the fixtures' writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def write_fixtures(only=None) -> None:
    """With the JAX package on the CPU, under ``set_nonrandom(True)``: the
    Tip5-16 and two-table circuits' builds, witnesses and sync proofs (and
    the Tip5-16 one's bytes); the recursive verifier over the Tip5-16 proof
    (its common and verifier data, and a SHA-256 of every column of its
    witness); the 2^16-entry table's build (common and verifier data)."""
    import time

    from test_torch_zk import _jax_setup, jax_prove_fixture

    _jax_setup()
    from plonky2_goldibear_tpu.iop import generator as gen
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    t0 = time.time()

    def write_bins(prefix, data):
        for part, blob in (
                ("common", jser.write_common_circuit_data(data.common)),
                ("verifier", jser.write_verifier_only_circuit_data(
                    data.verifier_only, data.common.spec))):
            with open(bin_path(f"{prefix}_{part}"), "wb") as f:
                f.write(blob)

    if only in (None, "u16"):
        b = _jax_builder()
        circuits.u16_table(b)
        data = b.build()
        assert data.common.degree_bits == 12, data.common.degree_bits
        write_bins("u16", data)
        print(f"wrote the u16 table's build after {time.time() - t0:.0f} s",
              flush=True)
    for name, (fn, values) in CIRCUITS.items():
        if only not in (None, name):
            continue
        b = _jax_builder()
        ins = fn(b)
        data = b.build()
        pw = JPartialWitness()
        pw.set_targets(ins, values)
        proof = jax_prove_fixture(
            data, pw, npz_path(name),
            bins="lookup_tip5" if name == "tip5" else None, lookups=True)
        if name != "tip5":
            continue
        ob = _jax_builder()
        proof_t, vk_t = circuits.recursive_verifier(ob, data.common, rv=jrv)
        outer = ob.build()
        write_bins("recursive", outer)
        opw = JPartialWitness()
        jrv.set_proof_with_pis_target(opw, proof_t, proof)
        jrv.set_verifier_data_target(opw, vk_t, data.verifier_only)
        gen.set_nonrandom(True)
        part = gen.generate_partial_witness(opw, outer.prover_only,
                                            outer.common)
        np.savez_compressed(
            npz_path("recursive"),
            column_sha256=column_digests(part.full_witness()),
            public_inputs=np.asarray(part.get_targets(
                outer.prover_only.public_inputs), dtype=np.uint64),
            counter=np.asarray(int(gen._NONRANDOM_COUNTER),
                               dtype=np.uint64))
        print(f"wrote the recursive outer over Tip5-16 (2^"
              f"{outer.common.degree_bits}) after {time.time() - t0:.0f} s",
              flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the lookup fixtures from the JAX package (or, "
                    "without --write-fixtures, run these tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    ap.add_argument("--only", choices=["u16", "tip5", "two_tables"])
    cli = ap.parse_args()
    if cli.write_fixtures:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        write_fixtures(cli.only)
    else:
        sys.exit(pytest.main([__file__, "-q"]))
