"""The port's recursive-verifier circuit against the JAX package, on the
CPU, exact (tolerance zero everywhere: gate rows, copy constraints, field
values, caps, digests and witness columns compared with equality).

(a) Modules, live: the witness generators of the 8 recursive-verifier
    gates against the JAX generators on seeded random inputs; the 13 gates
    of the outer circuit evaluated over the port's ``DeviceBaseAlgebra``
    against their host form at each point and against the JAX
    ``eval_unfiltered`` over the JAX ``DeviceBaseAlgebra``, and the
    prover's form (``vanishing.gate_constraints_device``: the stacked form
    of PoseidonGate, the algebra of the rest) against both.
(b) The extension ops and gadgets: ``circuits.ext_mix`` built by both
    builders (rows, copies, constants, slots), and the port's build and
    witness against ``data/builder_ext_mix.npz``.
(c) The outer circuit over the 2^6 chain (``circuits.recursive_verifier``):
    built by both builders before ``build`` (live), and the port's build
    and witness of the stored 2^6 proof against
    ``data/recursive_gl_2e6inner_{common,verifier}.bin`` (read by the
    port's reader) and ``recursive_gl_2e6inner.npz`` (a SHA-256 of every
    wire column, so a mismatch names the column; the public inputs; the
    nonrandom counter).  The outer over the 2^12 chain costs a 2^12 commit
    like this one; its fixture ``recursive_gl_2e12inner_*.bin`` is checked
    on the card (``tests/test_torch_recursion_prove.py``, ``-m gpu``, and
    ``chip_smoke.py``).

No JAX ``build()`` or prover runs here; the fixtures are written by the
JAX package with

    python tests/test_torch_recursion.py --write-fixtures
"""

from __future__ import annotations

import dataclasses
import hashlib
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
from plonky2_goldibear_torch.field import gl, host  # noqa: E402
from plonky2_goldibear_torch.gates import gate_from_id  # noqa: E402
from plonky2_goldibear_torch.gates.base import (  # noqa: E402
    DeviceBaseAlgebra, EvaluationVars, HostBaseAlgebra)
from plonky2_goldibear_torch.gates.coset_interpolation import \
    CosetInterpolationGate  # noqa: E402
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.plonk import gadgets  # noqa: E402
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk import vanishing  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import (  # noqa: E402
    DATA_DIR, circuit_meta, read_fixture)
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.recursion import \
    recursive_verifier as rv  # noqa: E402

torch.set_num_threads(1)
SPEC = host.GOLDILOCKS
P = SPEC.p
MIX_PATH = os.path.join(DATA_DIR, "builder_ext_mix.npz")
# the 13 gates of the outer circuit, as the reference prints them
OUTER_GATES = (
    "NoopGate", "ConstantGate { num_consts: 2 }",
    "PoseidonMdsGate(PhantomData<plonky2_field::goldilocks_field::"
    "GoldilocksField>)<WIDTH=12>",
    "PublicInputGate<4>", "BaseSumGate { num_limbs: 63 } + Base: 2",
    "ReducingExtensionGate { num_coeffs: 32 }",
    "ReducingGate { num_coeffs: 43 }",
    "ArithmeticExtensionGate { num_ops: 10 }",
    "ArithmeticGate { num_ops: 20 }", "MulExtensionGate { num_ops: 13 }",
    "RandomAccessGate { bits: 4, num_copies: 4, num_extra_constants: 2 }",
    "4,6,[" + ", ".join(str(w) for w in CosetInterpolationGate.with_max_degree(
        4, 8, SPEC).barycentric_weights) + "]<D=2>",
    "PoseidonGate<WIDTH=12>")


def config():
    return CircuitConfig.standard_recursion_config_gl()


def short_id(gate_id: str) -> str:
    """A test id: the gate's name."""
    return "CosetInterpolationGate" if gate_id[0].isdigit() else \
        gate_id.split(" ")[0].split("(")[0].split("<")[0]


def inner_path(bits: int, part: str) -> str:
    """A byte fixture of the GL arith chain (2^6) or of the outer circuit
    over the 2^bits chain (``part`` "outer_common", "outer_verifier")."""
    if part.startswith("outer_"):
        return os.path.join(DATA_DIR, f"recursive_gl_2e{bits}inner_"
                                      f"{part[len('outer_'):]}.bin")
    return os.path.join(DATA_DIR, f"arith_chain_2e{bits}_{part}.bin")


def witness_path() -> str:
    return os.path.join(DATA_DIR, "recursive_gl_2e6inner.npz")


def read_bin(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def column_digests(wires: np.ndarray) -> np.ndarray:
    """A SHA-256 of each wire column (num_wires, 32) uint8."""
    return np.stack([np.frombuffer(hashlib.sha256(
        np.ascontiguousarray(col, dtype=np.uint64).tobytes()).digest(),
        dtype=np.uint8) for col in wires])


# --------------------------------------------------------------------------
# (a) the generators and the gates' evaluation, live against JAX
# --------------------------------------------------------------------------


def _run_both(port_gen, jax_gen, num_wires, values):
    """Run a port and a JAX generator on witnesses holding ``values``
    (wire column -> value at row 0); their output lists."""
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


def _jax_gate_by_class(gate_id):
    """The JAX gate of a reference id string, made from its class."""
    import re

    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.gates import access_gates as ja
    from plonky2_goldibear_tpu.gates import basic_gates as jb
    from plonky2_goldibear_tpu.gates import coset_interpolation as jc
    from plonky2_goldibear_tpu.gates import extension_gates as je
    from plonky2_goldibear_tpu.gates import poseidon as jp
    from plonky2_goldibear_tpu.gates import poseidon_mds as jm
    from plonky2_goldibear_tpu.gates import reducing as jr

    port = gate_from_id(gate_id, SPEC)
    n = [int(v) for v in re.findall(r"\d+", gate_id)]
    makers = {
        "NoopGate": lambda: jb.NoopGate(),
        "ConstantGate": lambda: jb.ConstantGate(n[0]),
        "PublicInputGate": lambda: jb.PublicInputGate(n[0]),
        "ArithmeticGate": lambda: jb.ArithmeticGate(n[0]),
        "PoseidonGate": lambda: jp.PoseidonGate(),
        "PoseidonMdsGate": lambda: jm.PoseidonMdsGate(2),
        "BaseSumGate": lambda: ja.BaseSumGate(n[0], n[1]),
        "ReducingExtensionGate": lambda: jr.ReducingExtensionGate(n[0], 2),
        "ReducingGate": lambda: jr.ReducingGate(n[0], 2),
        "ArithmeticExtensionGate":
            lambda: je.ArithmeticExtensionGate(n[0], 2),
        "MulExtensionGate": lambda: je.MulExtensionGate(n[0], 2),
        "RandomAccessGate": lambda: ja.RandomAccessGate(n[0], n[1], n[2]),
    }
    for prefix, make in makers.items():
        if gate_id.startswith(prefix):
            gate = make()
            break
    else:
        gate = jc.CosetInterpolationGate(port.subgroup_bits, 8,
                                         jhost.GOLDILOCKS)
    assert gate.id() == gate_id
    return gate


def _random_values(rng, n):
    return [int(v) for v in rng.integers(0, P, n, dtype=np.uint64)]


GENERATOR_GATES = [g for g in OUTER_GATES if not g.startswith(
    ("Noop", "Constant", "PublicInput", "ArithmeticGate", "PoseidonGate"))]


@pytest.mark.parametrize("gate_id", GENERATOR_GATES, ids=short_id)
def test_generators_match_jax(gate_id):
    """Every generator of one row of each of the 8 gates on seeded random
    inputs (bits and indices where the gate needs them)."""
    from plonky2_goldibear_tpu.field import host as jhost

    gate, jgate = gate_from_id(gate_id, SPEC), _jax_gate_by_class(gate_id)
    gens = gate.generators(0, [5, 9], SPEC)
    jgens = jgate.generators(0, [5, 9], jhost.GOLDILOCKS)
    assert len(gens) == len(jgens) >= 1
    rng = np.random.default_rng(sum(gate_id.encode()))
    for g, jg in zip(gens, jgens):
        deps = g.dependencies()
        assert deps == jg.dependencies()
        values = dict(zip((t[2] for t in deps),
                          _random_values(rng, len(deps))))
        if gate_id.startswith("RandomAccess"):
            values[gate.wire_access_index(g.copy)] = int(
                rng.integers(gate.vec_size))
        if gate_id.startswith("BaseSum"):
            values[0] = int(rng.integers(0, 1 << 63))
        got, want = _run_both(g, jg, 135, values)
        assert got == want and got


def _points(rng, n_wires, n_consts, m):
    return (rng.integers(0, P, (n_wires, m), dtype=np.uint64),
            rng.integers(0, P, (n_consts, m), dtype=np.uint64),
            rng.integers(0, P, 4, dtype=np.uint64))


@pytest.mark.parametrize("gate_id", OUTER_GATES, ids=short_id)
def test_circuit_evaluation_matches_jax(gate_id):
    """``eval_unfiltered`` over ``CircuitExtAlgebra`` on both builders: the
    same rows, copies and constants.  An outer over an outer (the GL
    double recursion, the Keccak outer over a Poseidon outer) places the
    13 gates' constraints this way; PoseidonMdsGate computed a lane's D
    coefficients and their constraints interleaved, where the JAX gate
    computes the coefficients first, so those rows differed."""
    from plonky2_goldibear_tpu.gates import base as jbase
    from plonky2_goldibear_tpu.gates import circuit_algebra as jca
    from plonky2_goldibear_torch.gates.circuit_algebra import \
        CircuitExtAlgebra

    port, jax_ = _both_builders()
    states = []
    for b, A, EV, g in (
            (port, CircuitExtAlgebra, EvaluationVars,
             gate_from_id(gate_id, SPEC)),
            (jax_, jca.CircuitExtAlgebra, jbase.EvaluationVars,
             _jax_gate_by_class(gate_id))):
        consts = [b.add_virtual_extension_target()
                  for _ in range(g.num_constants())]
        wires = [b.add_virtual_extension_target()
                 for _ in range(g.num_wires())]
        pis = [b.add_virtual_extension_target() for _ in range(4)]
        g.eval_unfiltered(A(b), EV(consts, wires, pis))
        states.append(_state(b))
    assert states[0] == states[1]


@pytest.mark.parametrize("gate_id", OUTER_GATES, ids=short_id)
def test_device_evaluation_matches_host_and_jax(gate_id):
    """At 8 random points: the port's ``eval_unfiltered`` over
    ``DeviceBaseAlgebra`` (torch tensors), over ``HostBaseAlgebra`` (one
    point at a time) and the prover's form, and the JAX
    ``eval_unfiltered`` over the JAX ``DeviceBaseAlgebra``."""
    from plonky2_goldibear_tpu.field import gl as jgl
    from plonky2_goldibear_tpu.gates.base import \
        DeviceBaseAlgebra as JDeviceBaseAlgebra
    from plonky2_goldibear_tpu.gates.base import \
        EvaluationVars as JEvaluationVars

    gate, jgate = gate_from_id(gate_id, SPEC), _jax_gate_by_class(gate_id)
    m = 8
    rng = np.random.default_rng(len(gate_id))
    wires, consts, pi = _points(rng, 135, 2, m)
    A = DeviceBaseAlgebra(gl, "cpu")
    got = gate.eval_unfiltered(A, EvaluationVars(
        list(gl.from_ints(consts)), list(gl.from_ints(wires)),
        list(gl.from_ints(pi))))
    got = np.stack([gl.to_ints(v.expand(m)) for v in got]) if got else \
        np.zeros((0, m), np.uint64)
    assert got.shape == (gate.num_constraints(), m)
    H = HostBaseAlgebra(SPEC)
    for j in range(m):
        host_vals = gate.eval_unfiltered(H, EvaluationVars(
            [int(c) for c in consts[:, j]], [int(w) for w in wires[:, j]],
            [int(v) for v in pi]))
        assert [int(v) for v in got[:, j]] == host_vals
    def rows(a):
        return [jgl.from_ints(r) for r in a]

    jwant = jgate.eval_unfiltered(JDeviceBaseAlgebra(jgl, m), JEvaluationVars(
        rows(consts), rows(wires), [jgl.from_ints(v) for v in pi]))
    for k, v in enumerate(jwant):
        np.testing.assert_array_equal(
            got[k], np.broadcast_to(np.asarray(jgl.to_ints(v)), (m,)))
    np.testing.assert_array_equal(gl.to_ints(
        vanishing.gate_constraints_device(
            gl, gate, gl.from_ints(wires), gl.from_ints(consts),
            list(gl.from_ints(pi)))), got)


# --------------------------------------------------------------------------
# (b) the extension ops and gadgets
# --------------------------------------------------------------------------


def _both_builders():
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    return (CircuitBuilder(config()),
            JCircuitBuilder(JCircuitConfig.standard_recursion_config_gl()))


def _state(b):
    return ([(i.gate.id(), i.constants) for i in b.gate_instances],
            b.copy_constraints, b.constants_to_targets, b.public_inputs,
            b.current_slots, b.virtual_target_index)


def _jax_ext_mix(b):
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.gates.coset_interpolation import \
        CosetInterpolationGate as JCosetInterpolationGate
    from plonky2_goldibear_tpu.plonk import gadgets as jgadgets

    return circuits.ext_mix(b, jgadgets,
                            JCosetInterpolationGate(2, 8, jhost.GOLDILOCKS))


def _port_ext_mix(b):
    return circuits.ext_mix(b, gadgets, CosetInterpolationGate.with_max_degree(
        2, 8, SPEC))


def test_ext_mix_matches_jax_before_build():
    port, jax_ = _both_builders()
    _port_ext_mix(port)
    _jax_ext_mix(jax_)
    assert _state(port) == _state(jax_)
    ids = {i.gate.id() for i in port.gate_instances}
    for g in GENERATOR_GATES:
        if not g.startswith(("PoseidonMds", "4,6")):
            assert g in ids, g


@pytest.fixture(scope="module")
def ext_mix():
    """(data, circuit with the witness of ``EXT_MIX_INPUTS``, rng after
    witness generation, fixture arrays, fixture meta)."""
    b = CircuitBuilder(config())
    inputs = _port_ext_mix(b)
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_targets(inputs, circuits.EXT_MIX_INPUTS)
    rng = NonRandomRng(1)
    circuit = data.circuit(pw, rng)
    arrays, meta = read_fixture(MIX_PATH)
    return data, circuit, rng, arrays, meta


def test_ext_mix_build_matches_jax(ext_mix):
    data, _, _, arrays, meta = ext_mix
    assert circuit_meta(data, "goldilocks") == meta
    np.testing.assert_array_equal(
        data.F.to_ints(data.prover_only.constants_sigmas_values),
        arrays["constants_sigmas"])
    np.testing.assert_array_equal(
        np.asarray(data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        arrays["constants_sigmas_cap"])


def test_ext_mix_witness_matches_jax(ext_mix):
    _, circuit, rng, arrays, _ = ext_mix
    np.testing.assert_array_equal(circuit.F.to_ints(circuit.wires),
                                  arrays["wires"])
    assert circuit.public_inputs == [int(v) for v in arrays["public_inputs"]]
    assert rng.counter == int(arrays["counter"])


def test_unported_gadgets_raise_with_their_item():
    """The sum of 23 addends, one AddManyGate op in the reference (ROADMAP
    Queue 1 item 4b, now ported): the same rows, copies and slots as the
    JAX builder's, and the op's sum wire is the result."""
    states = []
    for b in _both_builders():
        x = b.add_virtual_target()
        b.register_public_input(b.add_many([x] * 23))
        states.append(_state(b))
    assert states[0] == states[1]
    assert [g for g, _ in states[0][0]] == [
        "AddManyGate { num_addends: 23, num_ops: 3 }"]
    assert states[0][3] == [("w", 0, 23)]


def test_exponentiation_gadgets_match_jax():
    """The four gadgets that place an ExponentiationGate, on both
    builders: the same rows, copies and constants."""
    from plonky2_goldibear_tpu.plonk import gadgets as jgadgets

    states = []
    for b, gd in zip(_both_builders(), (gadgets, jgadgets)):
        x = b.add_virtual_target()
        bits = b.add_virtual_targets(21)
        b.register_public_inputs([
            gd.exp_from_bits(b, x, bits[:3]), gd.exp_u64(b, x, 5),
            gd.exp_power_of_2(b, x, 21),
            gd.exp_from_bits_const_base(b, 3, bits)])
        states.append(_state(b))
    assert states[0] == states[1]
    assert any(g.startswith("ExponentiationGate") for g, _ in states[0][0])


# --------------------------------------------------------------------------
# (c) the outer circuit over the 2^6 chain
# --------------------------------------------------------------------------


def _inner(bits=6):
    common = ser.read_common_circuit_data(read_bin(inner_path(bits,
                                                              "common")))
    return (common,
            ser.read_verifier_only_circuit_data(read_bin(
                inner_path(bits, "verifier"))),
            ser.read_proof_with_public_inputs(
                read_bin(inner_path(bits, "proof")), common))


def test_outer_matches_jax_before_build():
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    port, jax_ = _both_builders()
    blob = read_bin(inner_path(6, "common"))
    circuits.recursive_verifier(port, ser.read_common_circuit_data(blob))
    circuits.recursive_verifier(jax_, jser.read_common_circuit_data(blob),
                                rv=jrv)
    assert _state(port) == _state(jax_)
    assert len(port.generators) == len(jax_.generators)


@pytest.fixture(scope="module")
def outer():
    """(data, circuit with the witness of the stored 2^6 proof, rng after
    witness generation), built by the port on the CPU."""
    common, vk, proof = _inner()
    b = CircuitBuilder(config())
    proof_t, vk_t = circuits.recursive_verifier(b, common)
    data = b.build(device="cpu")
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, proof)
    rv.set_verifier_data_target(pw, vk_t, vk)
    rng = NonRandomRng(1)
    return data, data.circuit(pw, rng), rng


def assert_common_equal(read, built):
    """The common data read from bytes equals a built circuit's."""
    assert dataclasses.asdict(read.config) == \
        dataclasses.asdict(built.config)
    assert read.fri_params == built.fri_params
    assert [g.id() for g in read.gates] == [g.id() for g in built.gates]
    assert read.selectors_info.selector_indices == \
        built.selectors_info.selector_indices
    assert [tuple(g) for g in read.selectors_info.groups] == \
        [tuple(g) for g in built.selectors_info.groups]
    for name in ("quotient_degree_factor", "num_gate_constraints",
                 "num_constants", "num_public_inputs", "k_is",
                 "num_partial_products", "spec"):
        assert getattr(read, name) == getattr(built, name), name


def test_outer_common_matches_jax(outer):
    data, _, _ = outer
    read = ser.read_common_circuit_data(read_bin(inner_path(6,
                                                            "outer_common")))
    assert_common_equal(read, data.common)
    assert data.common.degree_bits == 12
    assert sorted(g.id() for g in data.common.gates) == sorted(OUTER_GATES)


def test_outer_cap_and_digest_match_jax(outer):
    data, _, _ = outer
    assert data.verifier_only == ser.read_verifier_only_circuit_data(
        read_bin(inner_path(6, "outer_verifier")))


def test_outer_witness_matches_jax_column_by_column(outer):
    data, circuit, rng = outer
    with np.load(witness_path()) as z:
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
# the fixtures' writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def _jax_witness(data, pw):
    """The JAX witness generation under ``set_nonrandom(True)``: (dense
    wires, public inputs, counter)."""
    from plonky2_goldibear_tpu.iop import generator as gen

    gen.set_nonrandom(True)
    part = gen.generate_partial_witness(pw, data.prover_only, data.common)
    return (part.full_witness(),
            [int(v) for v in part.get_targets(data.prover_only.public_inputs)],
            int(gen._NONRANDOM_COUNTER))


def write_fixtures() -> None:
    """With the JAX package on the CPU: the ext mix's build and witness;
    the outer circuit over the 2^6 chain (built over the chain's byte
    fixture, witnessed from its stored proof) and over the 2^12 chain
    (built over the JAX build of the chain; build only)."""
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    from plonky2_goldibear_tpu.field import fft as jfft
    from plonky2_goldibear_tpu.field import gl as jgl
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    t0 = time.time()
    _, b = _both_builders()
    inputs = _jax_ext_mix(b)
    data = b.build()
    pw = JPartialWitness()
    pw.set_targets(inputs, circuits.EXT_MIX_INPUTS)
    wires, pis, counter = _jax_witness(data, pw)
    po = data.prover_only
    np.savez_compressed(
        MIX_PATH, meta=np.array(json.dumps(circuit_meta(data, "goldilocks"))),
        constants_sigmas=np.asarray(jgl.to_ints(jfft.fft(
            jgl, po.constants_sigmas_commitment.coeffs)), dtype=np.uint64),
        constants_sigmas_cap=np.asarray(
            data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        wires=wires, public_inputs=np.asarray(pis, dtype=np.uint64),
        counter=np.asarray(counter, dtype=np.uint64))
    print(f"wrote {MIX_PATH} after {time.time() - t0:.0f} s", flush=True)

    def write_outer(bits, inner_common, witness=None):
        _, b = _both_builders()
        proof_t, vk_t = circuits.recursive_verifier(b, inner_common, rv=jrv)
        data = b.build()
        assert data.common.degree_bits == 12
        for part, blob in (
                ("outer_common", jser.write_common_circuit_data(data.common)),
                ("outer_verifier", jser.write_verifier_only_circuit_data(
                    data.verifier_only, data.common.spec))):
            with open(inner_path(bits, part), "wb") as f:
                f.write(blob)
        if witness is not None:
            vk, proof = witness
            pw = JPartialWitness()
            jrv.set_proof_with_pis_target(pw, proof_t, proof)
            jrv.set_verifier_data_target(pw, vk_t, vk)
            wires, pis, counter = _jax_witness(data, pw)
            np.savez_compressed(
                witness_path(), column_sha256=column_digests(wires),
                public_inputs=np.asarray(pis, dtype=np.uint64),
                counter=np.asarray(counter, dtype=np.uint64))
        print(f"wrote the outer over 2^{bits} after {time.time() - t0:.0f} "
              "s", flush=True)

    common6 = jser.read_common_circuit_data(read_bin(inner_path(6,
                                                                "common")))
    write_outer(6, common6, (
        jser.read_verifier_only_circuit_data(read_bin(inner_path(
            6, "verifier"))),
        jser.read_proof_with_public_inputs(read_bin(inner_path(6, "proof")),
                                           common6)))
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    chain = JCircuitBuilder(JCircuitConfig.standard_recursion_config_gl())
    circuits.arith_chain(chain, 12)
    write_outer(12, chain.build().common)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the recursion fixtures from the JAX package (or, "
                    "without --write-fixtures, run these tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    cli = ap.parse_args()
    if cli.write_fixtures:
        write_fixtures()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
