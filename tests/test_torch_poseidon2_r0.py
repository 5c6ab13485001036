"""The width-24 Poseidon2 (risc0) hasher, its gate and the two BabyBear
misc gates in the port, against the JAX package, on the CPU, exact
(tolerance zero: field values, generator outputs, constraints, rows,
caps, digests and proofs compared with equality).

(a) ``hash/poseidon2_r0_bb.py``: the reference's permutation KAT; the host
    permutation and the plain-torch twin against the JAX ``permute_host``
    and the jnp ``permute`` on seeded states; the sponges (host and torch)
    against the JAX host sponges, and once against the jnp sponge.
(b) ``Poseidon2R0BabyBearGate``, ``ApplyMat4Gate`` and
    ``Poseidon2InternalPermutationGate`` at D = 4: the generators against
    the JAX generators; ``eval_unfiltered`` over the host base and
    extension algebras and the device algebra (the prover's form), against
    the JAX ``eval_unfiltered``; over the circuit algebra, the rows both
    builders place; the reader of tags 5, 18 and 19 against the JAX
    reader.
(c) The width-24 circuit (``circuits.r0_hash`` under
    ``recursion_config_bb_wide()``): the port's build against the JAX
    build (gates, degree, digest, constants-sigmas values and cap; its
    gate has no tag in the byte format, so no common-data bytes), the
    port's witness and proof under ``NonRandomRng`` against the JAX ones
    (``data/r0_hash.npz``); the proof verifies and a tampered copy does
    not.

The fixture is written by the JAX package on the CPU with

    python tests/test_torch_poseidon2_r0.py --write-fixtures
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
from plonky2_goldibear_torch.field import bb, host  # noqa: E402
from plonky2_goldibear_torch.gates import gate_from_id  # noqa: E402
from plonky2_goldibear_torch.gates.base import (  # noqa: E402
    DeviceBaseAlgebra, EvaluationVars, HostBaseAlgebra, HostExtAlgebra)
from plonky2_goldibear_torch.gates.circuit_algebra import \
    CircuitExtAlgebra  # noqa: E402
from plonky2_goldibear_torch.gates.misc_gates import (  # noqa: E402
    ApplyMat4Gate, Poseidon2InternalPermutationGate)
from plonky2_goldibear_torch.gates.poseidon2_bb_gate import \
    Poseidon2BabyBearGate  # noqa: E402
from plonky2_goldibear_torch.gates.poseidon2_r0_bb_gate import \
    Poseidon2R0BabyBearGate  # noqa: E402
from plonky2_goldibear_torch.hash import poseidon2_r0_bb as r0  # noqa: E402
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import (  # noqa: E402
    PartialWitness, PartitionWitness)
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk import vanishing  # noqa: E402
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
D = SPEC.ext_degree
FIXTURE = os.path.join(DATA_DIR, "r0_hash.npz")

# reference test_against_r0_values (poseidon2_risc0_babybear.rs:322-342)
KAT = [
    0x2ed3e23d, 0x12921fb0, 0x0e659e79, 0x61d81dc9, 0x32bae33b, 0x62486ae3,
    0x1e681b60, 0x24b91325, 0x2a2ef5b9, 0x50e8593e, 0x5bc818ec, 0x10691997,
    0x35a14520, 0x2ba6a3c5, 0x279d47ec, 0x55014e81, 0x5953a67f, 0x2f403111,
    0x6b8828ff, 0x1801301f, 0x2749207a, 0x3dc9cf21, 0x3c985ba2, 0x57a99864,
]


def _jbb_ints(x) -> np.ndarray:
    from plonky2_goldibear_tpu.field import bb as jbb

    return np.asarray(jbb.to_ints(x), dtype=np.uint64)


def _jbb(a: np.ndarray):
    from plonky2_goldibear_tpu.field import bb as jbb

    return jbb.from_ints(np.asarray(a, dtype=np.uint64))


# --------------------------------------------------------------------------
# (a) the permutation and the sponges
# --------------------------------------------------------------------------


def test_permutation_kat():
    assert r0.permute_host(list(range(24))) == KAT
    got = bb.to_ints(r0.permute(bb.from_ints(np.arange(24, dtype=np.uint64))))
    assert [int(v) for v in got] == KAT


def test_permutation_matches_jax_host_and_jnp():
    from plonky2_goldibear_tpu.hash import poseidon2_r0_bb as jr0

    rng = np.random.default_rng(24)
    states = rng.integers(0, P, (2, 3, 24), dtype=np.uint64)
    states[0, 0] = P - 1
    got = bb.to_ints(r0.permute(bb.from_ints(states)))
    np.testing.assert_array_equal(got, _jbb_ints(jr0.permute(_jbb(states))))
    for s, g in zip(states.reshape(-1, 24), got.reshape(-1, 24)):
        want = jr0.permute_host([int(v) for v in s])
        assert r0.permute_host([int(v) for v in s]) == want
        assert [int(v) for v in g] == want


@pytest.mark.parametrize("length", [0, 8, 16, 40])
def test_sponges_match_jax(length):
    """The host and torch sponges against the JAX host sponges row by row;
    at 40 inputs (two whole chunks, a zero-filled one, a second squeeze)
    also against the jnp sponge (each jnp call compiles for a few
    seconds, so only one)."""
    from plonky2_goldibear_tpu.hash import poseidon2_r0_bb as jr0

    rng = np.random.default_rng(100 + length)
    inputs = rng.integers(0, P, (3, length), dtype=np.uint64)
    fns = [(r0.hash_or_noop, r0.hash_or_noop_host, jr0.hash_or_noop_host),
           (lambda x: r0.hash_n_to_m_no_pad(x, 20),
            lambda x: r0.hash_n_to_m_no_pad_host(x, 20),
            lambda x: jr0.hash_n_to_m_no_pad_host(x, 20))]
    if length:
        fns.append((r0.hash_no_pad, r0.hash_no_pad_host,
                    jr0.hash_no_pad_host))
    for fn, host_fn, jhost_fn in fns:
        got = bb.to_ints(fn(bb.from_ints(inputs)))
        for row, g in zip(inputs, got):
            want = jhost_fn([int(v) for v in row])
            assert host_fn([int(v) for v in row]) == want
            assert [int(v) for v in g] == want
    if length == 40:
        np.testing.assert_array_equal(
            bb.to_ints(r0.hash_n_to_m_no_pad(bb.from_ints(inputs), 20)),
            _jbb_ints(jr0.hash_n_to_m_no_pad(_jbb(inputs), 20)))


def test_two_to_one_matches_jax():
    from plonky2_goldibear_tpu.hash import poseidon2_r0_bb as jr0

    rng = np.random.default_rng(7)
    x, y = rng.integers(0, P, (2, 4, 8), dtype=np.uint64)
    got = bb.to_ints(r0.two_to_one(bb.from_ints(x), bb.from_ints(y)))
    for a, b_, g in zip(x, y, got):
        want = jr0.two_to_one_host([int(v) for v in a], [int(v) for v in b_])
        assert r0.two_to_one_host([int(v) for v in a],
                                  [int(v) for v in b_]) == want
        assert [int(v) for v in g] == want


# --------------------------------------------------------------------------
# (b) the three gates at D = 4
# --------------------------------------------------------------------------


def _gates():
    """(port gate, JAX gate) pairs: the width-24 gate of the wide config,
    ApplyMat4Gate of the narrow config, Poseidon2InternalPermutationGate,
    and the width-16 Poseidon2 gate of the narrow config."""
    from plonky2_goldibear_tpu.gates import misc_gates as jm
    from plonky2_goldibear_tpu.gates import poseidon2_bb_gate as jp2
    from plonky2_goldibear_tpu.gates import poseidon2_r0_bb_gate as jr
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    wide = JCircuitConfig.recursion_config_bb_wide()
    narrow = JCircuitConfig.standard_recursion_config_bb()
    return {
        "r0": (Poseidon2R0BabyBearGate.from_config(
            CircuitConfig.recursion_config_bb_wide()),
            jr.Poseidon2R0BabyBearGate.from_config(wide)),
        "mat4": (ApplyMat4Gate.from_config(
            CircuitConfig.standard_recursion_config_bb(), D),
            jm.ApplyMat4Gate.from_config(narrow, D)),
        "internal": (Poseidon2InternalPermutationGate(D),
                     jm.Poseidon2InternalPermutationGate(D)),
        "p2": (Poseidon2BabyBearGate.from_config(
            CircuitConfig.standard_recursion_config_bb()),
            jp2.Poseidon2BabyBearGate.from_config(narrow)),
    }


GATES = ["r0", "mat4", "internal"]


def jax_id(jgate) -> str:
    """The JAX gate's id as the reference prints it: the JAX
    ``Poseidon2InternalPermutationGate.id`` doubles the brace after the
    name (a plain string beside an f-string, ``gates/misc_gates.py:185``),
    where the reference's ``format!("{self:?}<D={D}>")`` has one."""
    return jgate.id().replace("Gate {{ ", "Gate { ")


@pytest.mark.parametrize("name", GATES)
def test_gate_ids_and_shapes_match_jax(name):
    gate, jgate = _gates()[name]
    assert gate.id() == jax_id(jgate)
    assert gate_from_id(gate.id(), SPEC).id() == gate.id()
    for f in ("num_wires", "num_constants", "degree", "num_constraints"):
        assert getattr(gate, f)() == getattr(jgate, f)(), f


def _run_both(port_gen, jax_gen, num_wires, values):
    from plonky2_goldibear_tpu.iop.witness import \
        PartitionWitness as JPartitionWitness

    outs = []
    for g, W in ((port_gen, PartitionWitness),
                 (jax_gen, JPartitionWitness)):
        w = W(num_wires, 2, np.arange(2 * num_wires, dtype=np.int64))
        for col, v in values.items():
            w.set_target(("w", 0, col), v)
        assert g.run(w, out := [])
        outs.append(out)
    return outs


@pytest.mark.parametrize("swap", [0, 1])
@pytest.mark.parametrize("name", GATES)
def test_generators_match_jax(name, swap):
    from plonky2_goldibear_tpu.field import host as jhost

    gate, jgate = _gates()[name]
    gens = gate.generators(0, [], SPEC)
    jgens = jgate.generators(0, [], jhost.BABYBEAR)
    assert len(gens) == len(jgens) >= 1
    rng = np.random.default_rng(1000 * swap + len(name))
    for g, jg in zip(gens, jgens):
        deps = g.dependencies()
        assert deps == jg.dependencies()
        values = {t[2]: int(v) for t, v in zip(
            deps, rng.integers(0, P, len(deps), dtype=np.uint64))}
        if name == "r0":
            values[gate.wire_swap(g.op)] = swap
        got, want = _run_both(g, jg, gate.num_wires(), values)
        assert got == want and got
    if name == "r0":
        # the outputs are the permutation of the (swapped) inputs
        ins = [values[gate.wire_input(0, i)] for i in range(24)]
        if swap:
            ins = ins[8:16] + ins[:8] + ins[16:]
        outs = dict(got)
        assert [outs[("w", 0, gate.wire_output(0, i))]
                for i in range(24)] == r0.permute_host(ins)


def _witness_points(gate, rng, m):
    """Wires at m points that satisfy the gate: random inputs (random
    bits for the swap flags), the rest filled by its generators."""
    from plonky2_goldibear_torch.iop import target as tgt

    swaps = {gate.wire_swap(op) for op in range(gate.num_ops)} \
        if isinstance(gate, Poseidon2R0BabyBearGate) else set()
    cols = np.zeros((gate.num_wires(), m), dtype=np.uint64)
    for j in range(m):
        w = PartitionWitness(gate.num_wires(), 1,
                             np.arange(gate.num_wires(), dtype=np.int64))
        for g in gate.generators(0, [], SPEC):
            for t in g.dependencies():
                if not w.filled[w.index(t)]:
                    w.set_target(t, int(rng.integers(
                        2 if t[2] in swaps else P)))
            assert g.run(w, out := [])
            for t, v in out:
                w.set_target(t, v)
        cols[:, j] = [w.get_target(tgt.wire(0, c)) if w.filled[c] else
                      int(rng.integers(P)) for c in range(gate.num_wires())]
    return cols


@pytest.mark.parametrize("name", GATES)
def test_evaluation_matches_jax_on_every_algebra(name):
    """At 4 points (2 satisfying, 2 random): the port's ``eval_unfiltered``
    over ``DeviceBaseAlgebra``, the prover's form and ``HostBaseAlgebra``
    point by point; the JAX ``eval_unfiltered`` over the JAX
    ``DeviceBaseAlgebra``; at one extension point, the port's and the
    JAX ``HostExtAlgebra``."""
    from plonky2_goldibear_tpu.field import bb as jbb
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.gates import base as jbase

    gate, jgate = _gates()[name]
    rng = np.random.default_rng(len(name) + 40)
    good = _witness_points(gate, rng, 2)
    wires = np.concatenate([good, rng.integers(
        0, P, (gate.num_wires(), 2), dtype=np.uint64)], axis=1)
    m = wires.shape[1]
    pi = rng.integers(0, P, 8, dtype=np.uint64)
    got = gate.eval_unfiltered(DeviceBaseAlgebra(bb, "cpu"), EvaluationVars(
        [], list(bb.from_ints(wires)), list(bb.from_ints(pi))))
    got = np.stack([bb.to_ints(v.expand(m)) for v in got])
    assert got.shape == (gate.num_constraints(), m)
    assert not got[:, :2].any() and got[:, 2:].any()
    for j in range(m):
        assert gate.eval_unfiltered(HostBaseAlgebra(SPEC), EvaluationVars(
            [], [int(v) for v in wires[:, j]], [int(v) for v in pi])) == \
            [int(v) for v in got[:, j]]
    jwant = jgate.eval_unfiltered(
        jbase.DeviceBaseAlgebra(jbb, m),
        jbase.EvaluationVars([], [jbb.from_ints(r) for r in wires],
                             [jbb.from_ints(v) for v in pi]))
    for k, v in enumerate(jwant):
        np.testing.assert_array_equal(
            got[k], np.broadcast_to(np.asarray(jbb.to_ints(v)), (m,)))
    np.testing.assert_array_equal(bb.to_ints(
        vanishing.gate_constraints_device(
            bb, gate, bb.from_ints(wires), bb.from_ints(
                np.zeros((0, m), np.uint64)), list(bb.from_ints(pi)))), got)
    ext = [tuple(int(v) for v in rng.integers(0, P, D, dtype=np.uint64))
           for _ in range(gate.num_wires())]
    epi = [tuple(int(v) for v in rng.integers(0, P, D, dtype=np.uint64))
           for _ in range(8)]
    assert gate.eval_unfiltered(HostExtAlgebra(SPEC),
                                EvaluationVars([], ext, epi)) == \
        jgate.eval_unfiltered(jbase.HostExtAlgebra(jhost.BABYBEAR),
                              jbase.EvaluationVars([], ext, epi))


def _state(b):
    return ([(i.gate.id(), i.constants) for i in b.gate_instances],
            b.copy_constraints, b.constants_to_targets, b.current_slots,
            b.virtual_target_index)


@pytest.mark.parametrize("name", ["mat4", "internal", "r0", "p2"])
def test_circuit_evaluation_matches_jax(name):
    """``eval_unfiltered`` over ``CircuitExtAlgebra``, the recursive
    verifier's form, on both builders (the narrow config, as the BB
    recursion builds it): the same rows, copies and constants, and
    constraint targets in the same places.  The width-16 gate's case
    holds the order of its swap constraints, which the BB recursive
    verifier over a Poseidon2 inner places."""
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.gates import base as jbase
    from plonky2_goldibear_tpu.gates import circuit_algebra as jca
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    gate, jgate = _gates()[name]
    outs = []
    states = []
    for b, A, EV, g in (
            (CircuitBuilder(CircuitConfig.standard_recursion_config_bb(),
                            SPEC), CircuitExtAlgebra, EvaluationVars, gate),
            (JCircuitBuilder(JCircuitConfig.standard_recursion_config_bb(),
                             spec=jhost.BABYBEAR), jca.CircuitExtAlgebra,
             jbase.EvaluationVars, jgate)):
        wires = [b.add_virtual_extension_target()
                 for _ in range(g.num_wires())]
        pi = [b.add_virtual_extension_target() for _ in range(8)]
        outs.append(g.eval_unfiltered(A(b), EV([], wires, pi)))
        states.append(_state(b))
    assert outs[0] == outs[1]
    assert states[0] == states[1]


def test_reader_reads_tags_5_18_and_19_as_jax():
    """The bytes of ExponentiationGate, ApplyMat4Gate (tag, then the
    field) and Poseidon2InternalPermutationGate, read by the port's and
    the JAX reader at D = 4: the JAX gates, ids as the reference prints
    them."""
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    from plonky2_goldibear_torch.gates.access_gates import \
        ExponentiationGate

    read = []
    for blob in ((5).to_bytes(4, "little") + (39).to_bytes(8, "little"),
                 (18).to_bytes(4, "little") + (5).to_bytes(8, "little"),
                 (19).to_bytes(4, "little")):
        gate = ser._read_gate(ser.Buffer(blob), SPEC,
                              CircuitConfig.standard_recursion_config_bb())
        jgate = jser._read_gate(jser.Buffer(blob), jhost.BABYBEAR,
                                JCircuitConfig.standard_recursion_config_bb())
        if isinstance(gate, ExponentiationGate):
            # the JAX id names the Goldilocks field and D = 2 at any field
            assert jgate.id() == gate.id().replace(
                "p3_baby_bear::baby_bear::BabyBear",
                "plonky2_field::goldilocks_field::GoldilocksField").replace(
                "<D=4>", "<D=2>")
        else:
            assert gate.id() == jax_id(jgate)
        assert gate.num_wires() == jgate.num_wires()
        assert gate.num_constraints() == jgate.num_constraints()
        read.append(gate)
    assert read[0].num_power_bits == 39 and read[0].spec is SPEC
    assert isinstance(read[1], ApplyMat4Gate) and read[1].num_ops == 5
    assert isinstance(read[2], Poseidon2InternalPermutationGate)
    assert read[2].D == D


# --------------------------------------------------------------------------
# (c) the width-24 circuit
# --------------------------------------------------------------------------


def _port_build():
    b = CircuitBuilder(CircuitConfig.recursion_config_bb_wide(), SPEC)
    ins = circuits.r0_hash(b)
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_targets(ins, circuits.r0_hash_inputs())
    return data, pw


@pytest.fixture(scope="module")
def built():
    """(data, partial witness, proof from NonRandomRng(1), the counter
    after it)."""
    data, pw = _port_build()
    rng = NonRandomRng(1)
    proof = data.prove(pw, rng=rng)
    return data, pw, proof, rng.counter


def test_builder_places_the_width24_gate():
    b = CircuitBuilder(CircuitConfig.recursion_config_bb_wide(), SPEC)
    x = b.add_virtual_targets(24)
    out = b.permute(x, hasher=r0)
    gate = b.gate_instances[out[0][1]].gate
    assert isinstance(gate, Poseidon2R0BabyBearGate) and gate.num_ops == 1
    with pytest.raises(ValueError, match="is a babybear hasher"):
        CircuitBuilder(CircuitConfig.standard_recursion_config_gl()).permute(
            x, hasher=r0)
    with pytest.raises(ValueError, match="in the circuit only"):
        CircuitBuilder(CircuitConfig.recursion_config_bb_wide(), SPEC,
                       hasher=r0)


def test_build_matches_jax(built):
    data = built[0]
    arrays, meta = read_fixture(FIXTURE)
    assert circuit_meta(data, "babybear") == meta
    assert any(g.startswith("Poseidon2R0BabyBearGate") for g in
               meta["gates"])
    np.testing.assert_array_equal(
        data.F.to_ints(data.prover_only.constants_sigmas_values),
        arrays["constants_sigmas"])
    np.testing.assert_array_equal(
        np.asarray(data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        arrays["constants_sigmas_cap"])


def test_build_matches_the_live_jax_builder_before_build():
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.hash import poseidon2_r0_bb as jr0
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    port = CircuitBuilder(CircuitConfig.recursion_config_bb_wide(), SPEC)
    jax_ = JCircuitBuilder(JCircuitConfig.recursion_config_bb_wide(),
                           spec=jhost.BABYBEAR)
    circuits.r0_hash(port)
    circuits.r0_hash(jax_, r0=jr0)
    assert _state(port) == _state(jax_)


def test_witness_matches_jax(built):
    data, pw = built[0], built[1]
    arrays, _ = read_fixture(FIXTURE)
    rng = NonRandomRng(1)
    circuit = data.circuit(pw, rng)
    np.testing.assert_array_equal(circuit.F.to_ints(circuit.wires),
                                  arrays["wires"])
    assert rng.counter == int(arrays["counter"])


def test_proof_matches_jax_bit_for_bit(built):
    proof, counter = built[2], built[3]
    arrays, _ = read_fixture(FIXTURE)
    flat = flatten_proof(proof)
    differ = [k for k, v in flat.items()
              if not np.array_equal(v, arrays["proof_" + k])]
    assert not differ, f"proof phases {differ} differ from the JAX proof"
    assert counter == int(arrays["proof_counter"])


def test_proof_verifies_and_a_tampered_copy_does_not(built):
    data, proof = built[0], built[2]
    data.verify(proof)
    bad = copy.deepcopy(proof)
    wires = bad.proof.openings.wires
    k = Poseidon2R0BabyBearGate(1).wire_output(0, 3)
    wires[k] = ((wires[k][0] + 1) % P,) + tuple(wires[k][1:])
    with pytest.raises(VerificationError):
        data.verify(bad)


# --------------------------------------------------------------------------
# the fixture's writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def write_fixtures() -> None:
    """With the JAX package on the CPU, under ``set_nonrandom(True)``: the
    width-24 circuit's build, witness and sync proof, verified.  The JAX
    persistent compile cache stays off: XLA:CPU crashes writing the width-24
    gate's quotient executable to it (the JAX package's own
    ``tests/test_poseidon2_r0.py`` turns it off the same way)."""
    from test_torch_zk import _jax_setup, jax_prove_fixture

    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    _jax_setup()
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.hash import poseidon2_r0_bb as jr0
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    b = JCircuitBuilder(JCircuitConfig.recursion_config_bb_wide(),
                        spec=jhost.BABYBEAR)
    ins = circuits.r0_hash(b, r0=jr0)
    data = b.build()
    pw = JPartialWitness()
    pw.set_targets(ins, circuits.r0_hash_inputs())
    jax_prove_fixture(data, pw, FIXTURE, field="babybear")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the width-24 circuit's fixture from the JAX "
                    "package (or, without --write-fixtures, run these "
                    "tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    cli = ap.parse_args()
    if cli.write_fixtures:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        write_fixtures()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
