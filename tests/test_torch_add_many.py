"""AddManyGate and the builder's ``add_many`` in the port, against the JAX
package, on the CPU, exact (tolerance zero: rows, field values, caps,
digests, witnesses and proofs compared with equality).

(a) The gate, live: its id and shape, its constraints over the port's
    ``HostBaseAlgebra`` and ``DeviceBaseAlgebra`` against the JAX
    ``eval_unfiltered`` over the JAX ``DeviceBaseAlgebra`` at seeded random
    points, over ``CircuitExtAlgebra`` (the rows a recursive verifier of a
    circuit with the gate places) against the JAX builder's, and its
    generators against the JAX generators.
(b) ``add_many`` on both builders: below, at and above the threshold of 23
    addends (one AddManyGate op at 23, chunks of 23 above it).
(c) ``circuits.add_many_sums`` (sums of 23, 46 and 100 addends): its build
    (metadata, constants/sigmas, cap, digest) and witness against
    ``data/add_many_sums.npz``; the common data (gate tag 17) and verifier
    data read from the JAX writers' bytes; its proof from
    ``NonRandomRng(1)`` against the JAX proof, bit for bit; the circuit
    loaded as data (``load_circuit`` takes the gate's id) proves the same.

The fixtures are written by the JAX package on the CPU with

    python tests/test_torch_add_many.py --write-fixtures
"""

from __future__ import annotations

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
from plonky2_goldibear_torch.gates import gate_from_id  # noqa: E402
from plonky2_goldibear_torch.gates.base import (  # noqa: E402
    DeviceBaseAlgebra, EvaluationVars, HostBaseAlgebra)
from plonky2_goldibear_torch.gates.misc_gates import \
    AddManyGate  # noqa: E402
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

torch.set_num_threads(1)
SPEC = host.GOLDILOCKS
P = SPEC.p
SUMS = "add_many_sums"
# (num_addends, num_ops): the builder's gate under the standard config,
# and other shapes the id and the serializer allow
SHAPES = ((23, 3), (4, 16), (1, 40), (79, 1))


def data_path(name: str) -> str:
    return os.path.join(DATA_DIR, name)


def read_bin(name: str) -> bytes:
    with open(data_path(name + ".bin"), "rb") as f:
        return f.read()


def _jax_gate(num_addends, num_ops):
    from plonky2_goldibear_tpu.gates.misc_gates import \
        AddManyGate as JAddManyGate

    return JAddManyGate(num_addends, num_ops)


def _both_builders():
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    return (CircuitBuilder(CircuitConfig.standard_recursion_config_gl()),
            JCircuitBuilder(JCircuitConfig.standard_recursion_config_gl()))


def _state(b):
    return ([(i.gate.id(), i.constants) for i in b.gate_instances],
            b.copy_constraints, b.constants_to_targets, b.public_inputs,
            b.current_slots, b.virtual_target_index)


# --------------------------------------------------------------------------
# (a) the gate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gate_id_and_shape_match_jax(shape):
    gate, jgate = AddManyGate(*shape), _jax_gate(*shape)
    assert gate.id() == jgate.id() == (
        f"AddManyGate {{ num_addends: {shape[0]}, num_ops: {shape[1]} }}")
    assert gate_from_id(gate.id(), SPEC) == gate
    for f in ("num_wires", "num_constants", "degree", "num_constraints"):
        assert getattr(gate, f)() == getattr(jgate, f)(), f
    for op in range(gate.num_ops):
        assert list(gate.wires_addends(op)) == list(jgate.wires_addends(op))
        assert gate.wire_sum(op) == jgate.wire_sum(op)


def test_from_config_is_the_builders_gate():
    cfg = CircuitConfig.standard_recursion_config_gl()
    gate = AddManyGate.from_config(cfg, 23)
    assert (gate.num_addends, gate.num_ops) == (23, 3)
    assert gate.num_wires() <= cfg.num_routed_wires


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_device_and_host_evaluation_match_jax(shape):
    """At 8 random points: ``eval_unfiltered`` over ``DeviceBaseAlgebra``,
    over ``HostBaseAlgebra`` one point at a time, and the JAX gate over
    the JAX ``DeviceBaseAlgebra``; then at points where every sum wire
    holds its sum, all zero."""
    from plonky2_goldibear_tpu.field import gl as jgl
    from plonky2_goldibear_tpu.gates.base import \
        DeviceBaseAlgebra as JDeviceBaseAlgebra
    from plonky2_goldibear_tpu.gates.base import \
        EvaluationVars as JEvaluationVars

    gate, jgate = AddManyGate(*shape), _jax_gate(*shape)
    m = 8
    rng = np.random.default_rng(sum(shape))
    wires = rng.integers(0, P, (gate.num_wires(), m), dtype=np.uint64)
    A = DeviceBaseAlgebra(gl, "cpu")

    def device_eval(w):
        out = gate.eval_unfiltered(A, EvaluationVars(
            [], list(gl.from_ints(w)), []))
        return np.stack([gl.to_ints(v.expand(m)) for v in out])

    got = device_eval(wires)
    assert got.shape == (gate.num_ops, m)
    H = HostBaseAlgebra(SPEC)
    for j in range(m):
        assert [int(v) for v in got[:, j]] == gate.eval_unfiltered(
            H, EvaluationVars([], [int(w) for w in wires[:, j]], []))
    jwant = jgate.eval_unfiltered(JDeviceBaseAlgebra(jgl, m), JEvaluationVars(
        [], [jgl.from_ints(r) for r in wires], []))
    for k, v in enumerate(jwant):
        np.testing.assert_array_equal(
            got[k], np.broadcast_to(np.asarray(jgl.to_ints(v)), (m,)))
    for op in range(gate.num_ops):
        wires[gate.wire_sum(op)] = [
            sum(int(wires[w, j]) for w in gate.wires_addends(op)) % P
            for j in range(m)]
    assert not device_eval(wires).any()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_circuit_evaluation_matches_jax(shape):
    """``eval_unfiltered`` over ``CircuitExtAlgebra`` on both builders: the
    same rows, copies and constants."""
    from plonky2_goldibear_tpu.gates import base as jbase
    from plonky2_goldibear_tpu.gates import circuit_algebra as jca

    from plonky2_goldibear_torch.gates.circuit_algebra import \
        CircuitExtAlgebra

    states = []
    for b, A, EV, g in zip(
            _both_builders(), (CircuitExtAlgebra, jca.CircuitExtAlgebra),
            (EvaluationVars, jbase.EvaluationVars),
            (AddManyGate(*shape), _jax_gate(*shape))):
        wires = [b.add_virtual_extension_target()
                 for _ in range(g.num_wires())]
        b.register_public_inputs([t for w in g.eval_unfiltered(
            A(b), EV([], wires, [])) for t in w])
        states.append(_state(b))
    assert states[0] == states[1]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_generators_match_jax(shape):
    """Every op's generator on seeded random addends: the same
    dependencies and the same sum on the same wire."""
    from plonky2_goldibear_tpu.iop.witness import \
        PartitionWitness as JPartitionWitness

    from plonky2_goldibear_torch.iop.witness import PartitionWitness

    gate, jgate = AddManyGate(*shape), _jax_gate(*shape)
    gens = gate.generators(3, [], SPEC)
    jgens = jgate.generators(3, [], SPEC)
    assert len(gens) == len(jgens) == gate.num_ops
    rng = np.random.default_rng(len(gens))
    for g, jg in zip(gens, jgens):
        deps = g.dependencies()
        assert deps == jg.dependencies()
        vals = [int(v) for v in rng.integers(0, P, len(deps),
                                             dtype=np.uint64)]
        outs = []
        for gen_, W in ((g, PartitionWitness), (jg, JPartitionWitness)):
            w = W(135, 4, np.arange(4 * 135, dtype=np.int64))
            for t, v in zip(deps, vals):
                w.set_target(t, v)
            assert gen_.run(w, out := [])
            outs.append(out)
        assert outs[0] == outs[1] == [(("w", 3, gate.wire_sum(g.op)),
                                       sum(vals) % P)]


# --------------------------------------------------------------------------
# (b) add_many on both builders
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", (1, 22, 23, 24, 46, 47, 70, 100))
def test_add_many_matches_jax(n):
    """The rows, copies, constants and slots of one sum of n addends; 23
    place one AddManyGate op, which the builders find with ``find_slot``."""
    states = []
    for b in _both_builders():
        xs = b.add_virtual_targets(n)
        b.register_public_input(b.add_many(xs))
        states.append(_state(b))
    assert states[0] == states[1]
    rows = [g for g, _ in states[0][0]]
    ops = n // 23
    assert sum(1 for g in rows if g.startswith("AddManyGate")) == \
        -(-ops // 3)


def test_add_many_packs_three_sums_a_row():
    b = CircuitBuilder(CircuitConfig.standard_recursion_config_gl())
    xs = b.add_virtual_targets(23)
    sums = [b.add_many(xs) for _ in range(4)]
    assert [s[1] for s in sums] == [0, 0, 0, 1]
    assert [s[2] for s in sums] == [23, 47, 71, 23]


# --------------------------------------------------------------------------
# (c) the add_many_sums circuit
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sums():
    """(data, circuit with the witness of ``ADD_MANY_INPUTS``, counter
    after witness generation, proof from that rng, fixture arrays and
    meta), built and proved by the port on the CPU."""
    b = CircuitBuilder(CircuitConfig.standard_recursion_config_gl())
    xs = circuits.add_many_sums(b)
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_targets(xs, circuits.ADD_MANY_INPUTS)
    rng = NonRandomRng(1)
    circuit = data.circuit(pw, rng)
    counter = rng.counter
    proof = prover.prove(circuit, device="cpu", rng=rng)
    arrays, meta = read_fixture(data_path(SUMS + ".npz"))
    return data, circuit, counter, proof, arrays, meta


@pytest.fixture(scope="module")
def jax_bytes():
    """(common, verifier data, proof) of the JAX build and proof, read by
    the port's reader from the JAX writers' bytes."""
    common = ser.read_common_circuit_data(read_bin(SUMS + "_common"))
    return (common,
            ser.read_verifier_only_circuit_data(read_bin(SUMS + "_verifier")),
            ser.read_proof_with_public_inputs(read_bin(SUMS + "_proof"),
                                              common))


def test_sums_rows_match_jax_before_build():
    states = []
    for b in _both_builders():
        circuits.add_many_sums(b)
        states.append(_state(b))
    assert states[0] == states[1]
    assert [g for g, _ in states[0][0]].count(
        "AddManyGate { num_addends: 23, num_ops: 3 }") == 3


def test_sums_build_matches_jax(sums, jax_bytes):
    data, _, _, _, arrays, meta = sums
    common, vk, _ = jax_bytes
    assert circuit_meta(data, "goldilocks") == meta
    np.testing.assert_array_equal(
        data.F.to_ints(data.prover_only.constants_sigmas_values),
        arrays["constants_sigmas"])
    np.testing.assert_array_equal(
        np.asarray(data.verifier_only.constants_sigmas_cap, np.uint64),
        arrays["constants_sigmas_cap"])
    assert data.verifier_only == vk
    assert data.common == common


def test_tag_17_reads_from_the_jax_bytes(jax_bytes):
    gates = [g for g in jax_bytes[0].gates if isinstance(g, AddManyGate)]
    assert [g.id() for g in gates] == [
        "AddManyGate { num_addends: 23, num_ops: 3 }"]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tag_17_reads_each_shape(shape):
    buf = ser.Buffer((17).to_bytes(4, "little")
                     + b"".join(v.to_bytes(8, "little") for v in shape))
    assert ser._read_gate(buf, SPEC, None) == AddManyGate(*shape)
    assert buf.pos == len(buf.data)


def test_sums_witness_matches_jax(sums):
    _, circuit, counter, _, arrays, _ = sums
    np.testing.assert_array_equal(circuit.F.to_ints(circuit.wires),
                                  arrays["wires"])
    xs = circuits.ADD_MANY_INPUTS
    assert circuit.public_inputs == [sum(xs[:n]) % P
                                     for n in circuits.ADD_MANY_COUNTS] == \
        [int(v) for v in arrays["public_inputs"]]
    assert counter == int(arrays["counter"])


@pytest.mark.parametrize("phase", PROOF_PHASES)
def test_sums_proof_matches_jax_bit_for_bit(sums, jax_bytes, phase):
    np.testing.assert_array_equal(flatten_proof(sums[3])[phase],
                                  flatten_proof(jax_bytes[2])[phase])


def test_sums_proof_verifies(sums, jax_bytes):
    data = sums[0]
    data.verify(sums[3])
    data.verify(jax_bytes[2])


def test_loaded_sums_circuit_proves_as_jax(sums, jax_bytes):
    _, _, _, _, arrays, meta = sums
    circuit = load_circuit(arrays, meta, device="cpu")
    assert AddManyGate(23, 3) in circuit.common.gates
    proof = prover.prove(circuit, device="cpu",
                         rng=NonRandomRng(int(arrays["counter"])))
    got, want = flatten_proof(proof), flatten_proof(jax_bytes[2])
    for phase in PROOF_PHASES:
        np.testing.assert_array_equal(got[phase], want[phase])


# --------------------------------------------------------------------------
# the fixtures' writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def write_fixtures() -> None:
    """With the JAX package on the CPU: ``add_many_sums``'s build, its
    witness under ``set_nonrandom(True)`` and its sync proof (verified),
    with the JAX writers' bytes."""
    from test_torch_zk import _jax_setup, jax_prove_fixture

    _jax_setup()
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness

    b = _both_builders()[1]
    xs = circuits.add_many_sums(b)
    data = b.build()
    pw = JPartialWitness()
    pw.set_targets(xs, circuits.ADD_MANY_INPUTS)
    jax_prove_fixture(data, pw, data_path(SUMS + ".npz"), bins=SUMS)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the AddManyGate fixtures from the JAX package "
                    "(or, without --write-fixtures, run these tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    cli = ap.parse_args()
    if cli.write_fixtures:
        write_fixtures()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
