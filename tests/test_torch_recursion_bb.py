"""BabyBear recursion with the port against the JAX package, on the CPU,
exact (tolerance zero: rows, copy constraints, field values, caps, digests,
witness columns and generator outputs compared with equality).

The outer circuit is ``circuits.recursive_verifier`` under
``standard_recursion_config_bb()`` (167 wires, 41 routed, 6 challenges,
bb4, Poseidon2 width 16, FRI arity 2^3): the reference's
recursive_verifier.rs:317 ``test_recursive_verifier_bb``.

(a) The gates of the outer over the BB 2^12 chain at D = 4 (those of the
    outer over the 2^6 chain and an ExponentiationGate), read from the JAX
    bytes by both readers: the generators of the nine recursive-verifier
    gates against the JAX generators, and every gate's
    ``eval_unfiltered`` over the device algebra, the host algebra and the
    prover's form against the JAX ``eval_unfiltered``.
(b) The outer over the BB 2^6 chain: built by both builders before
    ``build`` (live); the port's build against the JAX bytes
    ``data/recursive_bb_2e6inner_{common,verifier}.bin``; the port's
    witness of the stored 2^6 proof against the JAX witness column by
    column (``recursive_bb_2e6inner.npz``: a SHA-256 of each column, the
    public inputs, the nonrandom counter).
(c) A whole BB recursion at one FRI query round (outer 2^12 rows): it
    proves, verifies, and a tampered copy is rejected; a false inner proof
    is refused by witness generation.  On the card (``-m gpu``; skips
    without one), the full recursion over the BB 2^12 chain, its build
    against ``recursive_bb_2e12inner_*.bin``.

No JAX ``build()`` or prover runs here; the fixtures are written by the
JAX package with

    python tests/test_torch_recursion_bb.py --write-fixtures

    python -m pytest --noconftest tests/test_torch_recursion_bb.py -m gpu
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
from plonky2_goldibear_torch.field import bb, host  # noqa: E402
from plonky2_goldibear_torch.gates.base import (  # noqa: E402
    DeviceBaseAlgebra, EvaluationVars, HostBaseAlgebra)
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk import vanishing  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import DATA_DIR  # noqa: E402
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.plonk.verifier import \
    VerificationError  # noqa: E402
from plonky2_goldibear_torch.recursion import \
    recursive_verifier as rv  # noqa: E402

torch.set_num_threads(1)
SPEC = host.BABYBEAR
P = SPEC.p
SMALL_QUERIES = 1


def config():
    return CircuitConfig.standard_recursion_config_bb()


def small_config():
    cfg = config()
    return dataclasses.replace(cfg, fri_config=dataclasses.replace(
        cfg.fri_config, num_query_rounds=SMALL_QUERIES))


def path(name: str) -> str:
    return os.path.join(DATA_DIR, name)


def read_bin(name: str) -> bytes:
    with open(path(name), "rb") as f:
        return f.read()


def outer_common_bytes(bits: int) -> bytes:
    return read_bin(f"recursive_bb_2e{bits}inner_common.bin")


def _inner():
    """The stored BB 2^6 chain: (common, verifier data, proof)."""
    common = ser.read_common_circuit_data(
        read_bin("arith_chain_bb_2e6_common.bin"), SPEC)
    return (common,
            ser.read_verifier_only_circuit_data(
                read_bin("arith_chain_bb_2e6_verifier.bin"), SPEC),
            ser.read_proof_with_public_inputs(
                read_bin("arith_chain_bb_2e6_proof.bin"), common))


def _outer_gates(bits=12):
    """The gates of the outer over the 2^bits chain, read from the JAX
    writer's bytes by the port's and by the JAX reader (the 2^12 outer
    has every gate of the 2^6 one and an ExponentiationGate)."""
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.plonk import serialization as jser

    blob = outer_common_bytes(bits)
    return list(zip(ser.read_common_circuit_data(blob, SPEC).gates,
                    jser.read_common_circuit_data(blob,
                                                  jhost.BABYBEAR).gates))


# the outer's gates as the reference prints them, from the JAX bytes (none
# while the writer runs)
OUTER_GATES = [g.id() for g in ser.read_common_circuit_data(
    outer_common_bytes(12), SPEC).gates] if os.path.exists(
    path("recursive_bb_2e12inner_common.bin")) else []


def short_id(gate_id: str) -> str:
    """A test id: the gate's name (and its first number)."""
    if gate_id[0].isdigit():
        return "CosetInterpolationGate"
    name = gate_id.split(" ")[0].split("(")[0].split("<")[0]
    digits = [w.strip(",}") for w in gate_id.split() if w.strip(",}")
              .isdigit()]
    return f"{name}-{digits[0]}" if name == "RandomAccessGate" else name


def column_digests(wires: np.ndarray) -> np.ndarray:
    """A SHA-256 of each wire column (num_wires, 32) uint8."""
    import hashlib

    return np.stack([np.frombuffer(hashlib.sha256(
        np.ascontiguousarray(col, dtype=np.uint64).tobytes()).digest(),
        dtype=np.uint8) for col in wires])


# --------------------------------------------------------------------------
# (a) the outer's gates at D = 4, live against JAX
# --------------------------------------------------------------------------


def _gate_pair(gate_id):
    """(port gate, JAX gate) of the 2^12 outer, read from the same bytes."""
    return {g.id(): (g, jg) for g, jg in _outer_gates()}[gate_id]


def _run_both(port_gen, jax_gen, num_wires, values):
    from plonky2_goldibear_tpu.iop.witness import \
        PartitionWitness as JPartitionWitness

    from plonky2_goldibear_torch.iop.witness import PartitionWitness

    outs = []
    for g, W in ((port_gen, PartitionWitness),
                 (jax_gen, JPartitionWitness)):
        w = W(num_wires, 2, np.arange(2 * num_wires, dtype=np.int64))
        for col, v in values.items():
            w.set_target(("w", 0, col), v)
        assert g.run(w, out := [])
        outs.append(out)
    return outs


GENERATOR_GATES = [g for g in OUTER_GATES if not g.startswith(
    ("Noop", "Constant", "PublicInput", "ArithmeticGate", "Poseidon2"))]


def test_the_outer_has_nine_generator_gates():
    """The eight of the GL outer but PoseidonMdsGate, and the
    ExponentiationGate of the FRI query's x = g^index (15 index bits,
    more than the 10 ops of an ArithmeticGate)."""
    assert len(GENERATOR_GATES) == 9, GENERATOR_GATES
    assert sum(g.startswith("ExponentiationGate") for g in OUTER_GATES) == 1


@pytest.mark.parametrize("gate_id", GENERATOR_GATES, ids=short_id)
def test_generators_match_jax_at_d4(gate_id):
    """Every generator of one row of each recursive-verifier gate on
    seeded random inputs (bits and indices where the gate needs them)."""
    from plonky2_goldibear_tpu.field import host as jhost

    gate, jgate = _gate_pair(gate_id)
    consts = [5, 9][:gate.num_constants()] + [0] * max(
        0, gate.num_constants() - 2)
    gens = gate.generators(0, consts, SPEC)
    jgens = jgate.generators(0, consts, jhost.BABYBEAR)
    assert len(gens) == len(jgens) >= 1
    rng = np.random.default_rng(sum(gate_id.encode()))
    for g, jg in zip(gens, jgens):
        deps = g.dependencies()
        assert deps == jg.dependencies()
        values = {t[2]: int(v) for t, v in zip(
            deps, rng.integers(0, P, len(deps), dtype=np.uint64))}
        if gate_id.startswith("RandomAccess"):
            values[gate.wire_access_index(g.copy)] = int(
                rng.integers(gate.vec_size))
        if gate_id.startswith("BaseSum"):
            values[0] = int(rng.integers(0, 1 << gate.num_limbs))
        got, want = _run_both(g, jg, config().num_wires, values)
        assert got == want and got


@pytest.mark.parametrize("gate_id", OUTER_GATES, ids=short_id)
def test_device_evaluation_matches_host_and_jax_at_d4(gate_id):
    """At 4 random points: the port's ``eval_unfiltered`` over
    ``DeviceBaseAlgebra``, over ``HostBaseAlgebra`` point by point and
    the prover's form, against the JAX ``eval_unfiltered`` over the JAX
    ``DeviceBaseAlgebra``."""
    from plonky2_goldibear_tpu.field import bb as jbb
    from plonky2_goldibear_tpu.gates import base as jbase

    gate, jgate = _gate_pair(gate_id)
    m = 4
    rng = np.random.default_rng(len(gate_id))
    wires = rng.integers(0, P, (config().num_wires, m), dtype=np.uint64)
    consts = rng.integers(0, P, (2, m), dtype=np.uint64)
    pi = rng.integers(0, P, 8, dtype=np.uint64)
    got = gate.eval_unfiltered(DeviceBaseAlgebra(bb, "cpu"), EvaluationVars(
        list(bb.from_ints(consts)), list(bb.from_ints(wires)),
        list(bb.from_ints(pi))))
    got = np.stack([bb.to_ints(v.expand(m)) for v in got]) if got else \
        np.zeros((0, m), np.uint64)
    assert got.shape == (gate.num_constraints(), m)
    for j in range(m):
        assert gate.eval_unfiltered(HostBaseAlgebra(SPEC), EvaluationVars(
            [int(c) for c in consts[:, j]], [int(w) for w in wires[:, j]],
            [int(v) for v in pi])) == [int(v) for v in got[:, j]]
    jwant = jgate.eval_unfiltered(jbase.DeviceBaseAlgebra(jbb, m),
                                  jbase.EvaluationVars(
        [jbb.from_ints(r) for r in consts],
        [jbb.from_ints(r) for r in wires], [jbb.from_ints(v) for v in pi]))
    for k, v in enumerate(jwant):
        np.testing.assert_array_equal(
            got[k], np.broadcast_to(np.asarray(jbb.to_ints(v)), (m,)))
    np.testing.assert_array_equal(bb.to_ints(
        vanishing.gate_constraints_device(
            bb, gate, bb.from_ints(wires), bb.from_ints(consts),
            list(bb.from_ints(pi)))), got)


# --------------------------------------------------------------------------
# (b) the outer circuit over the BB 2^6 chain
# --------------------------------------------------------------------------


def _state(b):
    return ([(i.gate.id(), i.constants) for i in b.gate_instances],
            b.copy_constraints, b.constants_to_targets, b.public_inputs,
            b.current_slots, b.virtual_target_index)


def _jax_builder():
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    return JCircuitBuilder(JCircuitConfig.standard_recursion_config_bb(),
                           spec=jhost.BABYBEAR)


def test_outer_matches_jax_before_build():
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    port, jax_ = CircuitBuilder(config(), SPEC), _jax_builder()
    blob = read_bin("arith_chain_bb_2e6_common.bin")
    circuits.recursive_verifier(port, ser.read_common_circuit_data(blob,
                                                                   SPEC))
    circuits.recursive_verifier(
        jax_, jser.read_common_circuit_data(blob, jhost.BABYBEAR), rv=jrv)
    assert _state(port) == _state(jax_)
    assert len(port.generators) == len(jax_.generators)


@pytest.fixture(scope="module")
def outer():
    """(data, circuit with the witness of the stored 2^6 proof, rng after
    witness generation), built by the port on the CPU."""
    common, vk, proof = _inner()
    b = CircuitBuilder(config(), SPEC)
    proof_t, vk_t = circuits.recursive_verifier(b, common)
    data = b.build(device="cpu")
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, proof)
    rv.set_verifier_data_target(pw, vk_t, vk)
    rng = NonRandomRng(1)
    return data, data.circuit(pw, rng), rng


def test_outer_common_matches_jax(outer):
    from test_torch_recursion import assert_common_equal

    data, _, _ = outer
    assert_common_equal(ser.read_common_circuit_data(
        outer_common_bytes(6), SPEC), data.common)
    assert data.common.degree_bits == 13
    assert data.common.config == config()
    assert tuple(data.common.fri_params.reduction_arity_bits) == (3, 3, 3)


def test_outer_cap_and_digest_match_jax(outer):
    data, _, _ = outer
    assert data.verifier_only == ser.read_verifier_only_circuit_data(
        read_bin("recursive_bb_2e6inner_verifier.bin"), SPEC)


def test_outer_witness_matches_jax_column_by_column(outer):
    data, circuit, rng = outer
    with np.load(path("recursive_bb_2e6inner.npz")) as z:
        want, pis, counter = z["column_sha256"], z["public_inputs"], \
            int(z["counter"])
    got = column_digests(circuit.F.to_ints(circuit.wires))
    bad = [c for c in range(len(want)) if not np.array_equal(got[c],
                                                             want[c])]
    assert not bad, f"wire columns {bad} differ from the JAX witness"
    assert circuit.public_inputs == [int(v) for v in pis]
    assert rng.counter == counter
    _, _, proof = _inner()
    assert circuit.public_inputs == list(proof.public_inputs)


# --------------------------------------------------------------------------
# (c) whole BB recursions
# --------------------------------------------------------------------------


def recurse(cfg, inner_bits, device):
    """Prove the BB chain of 2^inner_bits rows (x = 3), build the outer
    circuit over it, witness and prove it: (inner data, inner proof, outer
    data, outer proof, the outer's witness of an inner proof)."""
    b = CircuitBuilder(cfg, SPEC)
    x = circuits.arith_chain(b, inner_bits)
    inner = b.build(device=device)
    pw = PartialWitness()
    pw.set_target(x, 3)
    inner_proof = inner.prove(pw, rng=NonRandomRng(1))
    inner.verify(inner_proof)
    ob = CircuitBuilder(cfg, SPEC)
    proof_t, vk_t = circuits.recursive_verifier(ob, inner.common)
    outer = ob.build(device=device)

    def witness(proof):
        pw = PartialWitness()
        rv.set_proof_with_pis_target(pw, proof_t, proof)
        rv.set_verifier_data_target(pw, vk_t, inner.verifier_only)
        return pw

    outer_proof = outer.prove(witness(inner_proof), rng=NonRandomRng(1))
    return inner, inner_proof, outer, outer_proof, witness


def tampered(proof):
    bad = copy.deepcopy(proof)
    wires = bad.proof.openings.wires
    wires[0] = ((wires[0][0] + 1) % P,) + tuple(wires[0][1:])
    return bad


@pytest.fixture(scope="module")
def small():
    return recurse(small_config(), 6, "cpu")


def test_small_bb_recursion_verifies(small):
    _, inner_proof, outer, outer_proof, _ = small
    assert outer.common.degree_bits == 12
    assert outer_proof.public_inputs == inner_proof.public_inputs
    outer.verify(outer_proof)


def test_small_bb_recursion_rejects_a_tampered_proof(small):
    _, _, outer, outer_proof, _ = small
    with pytest.raises(VerificationError):
        outer.verify(tampered(outer_proof))


def test_outer_witness_refuses_a_false_inner_proof(small):
    inner, inner_proof, outer, _, witness = small
    with pytest.raises(AssertionError,
                       match="does not fit|contradictory assignment"):
        outer.circuit(witness(tampered(inner_proof)), NonRandomRng(1))


@pytest.mark.gpu
def test_full_bb_recursion_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from test_torch_recursion import assert_common_equal

    _, inner_proof, outer, outer_proof, _ = recurse(config(), 12, "cuda")
    assert_common_equal(ser.read_common_circuit_data(
        outer_common_bytes(12), SPEC), outer.common)
    assert outer.verifier_only == ser.read_verifier_only_circuit_data(
        read_bin("recursive_bb_2e12inner_verifier.bin"), SPEC)
    outer.verify(outer_proof)
    with pytest.raises(VerificationError):
        outer.verify(tampered(outer_proof))
    assert outer_proof.public_inputs == inner_proof.public_inputs


# --------------------------------------------------------------------------
# the fixtures' writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def write_fixtures() -> None:
    """With the JAX package on the CPU: the outer over the BB 2^6 chain
    (built over the chain's byte fixture, witnessed from its stored proof
    under ``set_nonrandom(True)``) and over the BB 2^12 chain (built over
    the JAX build of the chain; build only)."""
    import time

    from test_torch_zk import _jax_setup

    _jax_setup()
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.iop import generator as gen
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    t0 = time.time()
    JSPEC = jhost.BABYBEAR

    def write_outer(bits, inner_common, witness=None):
        b = _jax_builder()
        proof_t, vk_t = circuits.recursive_verifier(b, inner_common, rv=jrv)
        data = b.build()
        for part, blob in (
                ("common", jser.write_common_circuit_data(data.common)),
                ("verifier", jser.write_verifier_only_circuit_data(
                    data.verifier_only, data.common.spec))):
            with open(path(f"recursive_bb_2e{bits}inner_{part}.bin"),
                      "wb") as f:
                f.write(blob)
        if witness is not None:
            vk, proof = witness
            pw = JPartialWitness()
            jrv.set_proof_with_pis_target(pw, proof_t, proof)
            jrv.set_verifier_data_target(pw, vk_t, vk)
            gen.set_nonrandom(True)
            part = gen.generate_partial_witness(pw, data.prover_only,
                                                data.common)
            np.savez_compressed(
                path("recursive_bb_2e6inner.npz"),
                column_sha256=column_digests(part.full_witness()),
                public_inputs=np.asarray(part.get_targets(
                    data.prover_only.public_inputs), dtype=np.uint64),
                counter=np.asarray(int(gen._NONRANDOM_COUNTER),
                                   dtype=np.uint64))
        print(f"wrote the outer over 2^{bits} (2^{data.common.degree_bits}"
              f" rows) after {time.time() - t0:.0f} s", flush=True)

    common6 = jser.read_common_circuit_data(
        read_bin("arith_chain_bb_2e6_common.bin"), JSPEC)
    write_outer(6, common6, (
        jser.read_verifier_only_circuit_data(
            read_bin("arith_chain_bb_2e6_verifier.bin"), JSPEC),
        jser.read_proof_with_public_inputs(
            read_bin("arith_chain_bb_2e6_proof.bin"), common6)))
    chain = _jax_builder()
    circuits.arith_chain(chain, 12)
    write_outer(12, chain.build().common)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the BB recursion fixtures from the JAX package "
                    "(or, without --write-fixtures, run these tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    cli = ap.parse_args()
    if cli.write_fixtures:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        write_fixtures()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
