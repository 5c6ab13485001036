"""The port's circuit builder and witness generation against the JAX
package, on the CPU, exact (tolerance zero everywhere: field values,
digests, layouts and proofs compared with equality).

(a) Module parity, live: the port's ``Forest`` and sigma polynomials,
    ``selector_polynomials``, ``fri_params`` and the witness generators of
    the Arithmetic, Poseidon-GL and Poseidon2-BB gates against the JAX
    package's host functions on inputs from ``numpy.random.default_rng``.
(b) The slice: both fields' 2^6 arithmetic chains built by the port
    (``plonky2_goldibear_torch.circuits.arith_chain``) against the
    committed JAX fixtures: constants/sigmas, cap, digest, layout; the
    witness of x = 3 under ``NonRandomRng(1)``, the counter it leaves; the
    proof and the permutation-argument retry against the stored JAX ones.
(c) A mixed circuit of every base-field gadget
    (``circuits.builder_mix``) against ``data/builder_mix{,_bb}.npz``, and
    the refusals of what this slice does not carry.

No JAX ``build()`` runs here (about 25 s a circuit); the mixed fixtures are
written by the JAX package with

    python tests/test_torch_builder.py --write-fixtures [--field babybear]
"""

from __future__ import annotations

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
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.plonk import prover  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import (  # noqa: E402
    DATA_DIR, circuit_meta, fixture_path, read_fixture)
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.plonk.proof import (  # noqa: E402
    PROOF_PHASES, flatten_proof)

torch.set_num_threads(1)
FIELDS = ("goldilocks", "babybear")
SPECS = {"goldilocks": host.GOLDILOCKS, "babybear": host.BABYBEAR}
PRESETS = {"goldilocks": "standard_recursion_config_gl",
           "babybear": "standard_recursion_config_bb"}


def config_of(field):
    return getattr(CircuitConfig, PRESETS[field])()


def mix_path(field):
    tag = "" if field == "goldilocks" else "_bb"
    return os.path.join(DATA_DIR, f"builder_mix{tag}.npz")


# --------------------------------------------------------------------------
# (a) module parity against the JAX package's host functions
# --------------------------------------------------------------------------


def _random_copies(rng, num_wires, num_routed, degree, num_virtual, count):
    """``count`` copy constraints between random routed wires and virtual
    targets."""
    def target():
        if rng.random() < 0.2:
            return ("v", int(rng.integers(num_virtual)))
        return ("w", int(rng.integers(degree)), int(rng.integers(num_routed)))

    return [(target(), target()) for _ in range(count)]


@pytest.mark.parametrize("num_wires,num_routed", [(135, 80), (167, 41)])
def test_forest_and_sigma_polys_match_jax(num_wires, num_routed):
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.plonk.permutation import Forest as JForest

    from plonky2_goldibear_torch.plonk.permutation import Forest

    degree_bits, num_virtual = 5, 300
    degree = 1 << degree_bits
    rng = np.random.default_rng(num_wires)
    copies = _random_copies(rng, num_wires, num_routed, degree, num_virtual,
                            2000)
    port = Forest(num_wires, num_routed, degree, num_virtual)
    jax_ = JForest(num_wires, num_routed, degree, num_virtual)
    for a, b in copies:
        port.merge(a, b)
        jax_.merge(a, b)
    port.compress_paths()
    jax_.compress_paths()
    np.testing.assert_array_equal(port.parents, jax_.parents)
    for spec, jspec in ((host.GOLDILOCKS, jhost.GOLDILOCKS),
                        (host.BABYBEAR, jhost.BABYBEAR)):
        k_is = host.get_unique_coset_shifts(spec, degree, num_routed)
        assert k_is == jhost.get_unique_coset_shifts(jspec, degree,
                                                     num_routed)
        subgroup = host.two_adic_subgroup(spec, degree_bits)
        got = port.wire_partition().get_sigma_polys(degree_bits, k_is,
                                                    subgroup, spec.p)
        want = jax_.wire_partition().get_sigma_polys(degree_bits, k_is,
                                                     subgroup, spec.p)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)


def _gate_pairs():
    """(port gate, JAX gate) pairs of every gate the port has."""
    from plonky2_goldibear_tpu.gates import basic_gates as jb
    from plonky2_goldibear_tpu.gates.poseidon import PoseidonGate as JPos
    from plonky2_goldibear_tpu.gates.poseidon2_bb_gate import \
        Poseidon2BabyBearGate as JPos2

    from plonky2_goldibear_torch.gates import basic_gates as pb
    from plonky2_goldibear_torch.gates.poseidon import PoseidonGate
    from plonky2_goldibear_torch.gates.poseidon2_bb_gate import \
        Poseidon2BabyBearGate

    return [(pb.NoopGate(), jb.NoopGate()),
            (pb.ConstantGate(2), jb.ConstantGate(2)),
            (pb.PublicInputGate(4), jb.PublicInputGate(4)),
            (pb.ArithmeticGate(20), jb.ArithmeticGate(20)),
            (PoseidonGate(), JPos()),
            (Poseidon2BabyBearGate(1), JPos2(1))]


def test_gates_builder_side_matches_jax():
    for port, jax_ in _gate_pairs():
        assert port.id() == jax_.id()
        assert (port.num_wires(), port.num_constants(), port.degree(),
                port.num_constraints(), port.num_ops) == \
            (jax_.num_wires(), jax_.num_constants(), jax_.degree(),
             jax_.num_constraints(), jax_.num_ops)
        assert port.extra_constant_wires() == jax_.extra_constant_wires()


@pytest.mark.parametrize("max_degree,seed", [(9, 0), (9, 1), (9, 2),
                                             (12, 3), (64, 4)])
def test_selector_polynomials_match_jax(max_degree, seed):
    """Random gate rows over a random subset of the gates: one or several
    groups at the recursion configs' 9, and at 12 and 64."""
    from plonky2_goldibear_tpu.gates import selectors as jsel

    from plonky2_goldibear_torch.gates import selectors as sel

    class Row:
        def __init__(self, gate):
            self.gate = gate

    rng = np.random.default_rng(seed)
    pairs = _gate_pairs()
    chosen = sorted(rng.choice(len(pairs), size=4, replace=False))
    pairs = sorted((pairs[i] for i in chosen),
                   key=lambda pg: (pg[0].degree(), pg[0].id()))
    rows = rng.integers(len(pairs), size=64)
    for p in (host.GOLDILOCKS.p, host.BABYBEAR.p):
        got, info = sel.selector_polynomials(
            [g for g, _ in pairs], [Row(pairs[r][0]) for r in rows],
            max_degree, p)
        want, jinfo = jsel.selector_polynomials(
            [g for _, g in pairs], [Row(pairs[r][1]) for r in rows],
            max_degree, p)
        assert info.selector_indices == jinfo.selector_indices
        assert info.groups == jinfo.groups
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("field", FIELDS)
def test_fri_params_match_jax(field):
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    fc = config_of(field).fri_config
    jfc = getattr(JCircuitConfig, PRESETS[field])().fri_config
    for degree_bits in range(3, 21):
        for hiding in (False, True):
            got = fc.fri_params(degree_bits, hiding)
            want = jfc.fri_params(degree_bits, hiding)
            assert got.reduction_arity_bits == want.reduction_arity_bits
            assert (got.degree_bits, got.hiding, got.final_poly_len) == \
                (want.degree_bits, want.hiding, want.final_poly_len)
    for bits in (6, 12):
        _, meta = read_fixture(fixture_path(bits, field))
        assert list(fc.fri_params(bits, False).reduction_arity_bits) == \
            meta["reduction_arity_bits"]


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


@pytest.mark.parametrize("p", [host.GOLDILOCKS.p, host.BABYBEAR.p])
def test_arithmetic_generator_matches_jax(p):
    from plonky2_goldibear_tpu.gates.basic_gates import \
        _ArithmeticOpGenerator as J

    from plonky2_goldibear_torch.gates.basic_gates import \
        _ArithmeticOpGenerator

    rng = np.random.default_rng(7)
    for i in (0, 5, 19):
        c0, c1, *ins = (int(v) for v in rng.integers(0, p, 5,
                                                      dtype=np.uint64))
        values = {4 * i + k: v for k, v in enumerate(ins)}
        got, want = _run_both(_ArithmeticOpGenerator(0, c0, c1, i, p),
                              J(0, c0, c1, i, p), 80, values)
        assert got == want and len(got) == 1


@pytest.mark.parametrize("swap", [0, 1])
def test_poseidon_generator_matches_jax(swap):
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.gates.poseidon import PoseidonGenerator as J

    from plonky2_goldibear_torch.gates.poseidon import (PoseidonGate,
                                                        PoseidonGenerator)

    rng = np.random.default_rng(11 + swap)
    p = host.GOLDILOCKS.p
    values = {i: int(rng.integers(0, p, dtype=np.uint64))
              for i in range(12)}
    values[PoseidonGate.WIRE_SWAP] = swap
    got, want = _run_both(PoseidonGenerator(0, host.GOLDILOCKS),
                          J(0, jhost.GOLDILOCKS), 135, values)
    assert got == want
    assert len(got) == PoseidonGate.END - 12 - 1


@pytest.mark.parametrize("num_ops,op,swap", [(1, 0, 0), (1, 0, 1),
                                             (2, 1, 1)])
def test_poseidon2_generator_matches_jax(num_ops, op, swap):
    """The narrow config's one op, and op 1 of a two-op gate (the wide
    config's), whose wires start after both ops' routed wires."""
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.gates.poseidon2_bb_gate import (
        Poseidon2BabyBearGate as JGate, _Poseidon2Generator as J)

    from plonky2_goldibear_torch.gates.poseidon2_bb_gate import (
        Poseidon2BabyBearGate, _Poseidon2Generator)

    gate, jgate = Poseidon2BabyBearGate(num_ops), JGate(num_ops)
    rng = np.random.default_rng(13 + 2 * op + swap)
    values = {gate.wire_input(op, i): int(rng.integers(0, host.BABYBEAR.p))
              for i in range(16)}
    values[gate.wire_swap(op)] = swap
    got, want = _run_both(_Poseidon2Generator(gate, 0, op, host.BABYBEAR),
                          J(jgate, 0, op, jhost.BABYBEAR), 334, values)
    assert got == want and len(got) == 8 + 16 * 7 + 13 + 16


def test_poseidon2_complete_wires_matches_jax():
    """A two-op Poseidon2 row with one op used: the builder routes zeros
    into the other op, as the JAX builder does."""
    from dataclasses import replace

    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    copies = []
    for make, cfg, spec in (
            (CircuitBuilder, config_of("babybear"), host.BABYBEAR),
            (JCircuitBuilder, JCircuitConfig.standard_recursion_config_bb(),
             jhost.BABYBEAR)):
        b = make(replace(cfg, num_wires=334, num_routed_wires=160), spec=spec)
        state = b.add_virtual_targets(16)
        b.permute(state)
        ((gate_id, slots),) = b.current_slots.items()
        ((params, (row, op)),) = slots.items()
        assert op == 1
        assert b._slot_gates[gate_id].complete_wires(b, row, op)
        copies.append(b.copy_constraints)
    assert copies[0] == copies[1] and len(copies[0]) == 17 + 17


def _gadget_circuit(b):
    """``builder_mix`` and the gadgets it does not call, on builder b."""
    a, c = circuits.builder_mix(b)
    b.register_public_inputs(b.hash_or_noop([a, c, b.neg_one()]))
    b.register_public_inputs(b.hash_or_noop([a, c] * 5))
    b.register_public_inputs(b.permute_swapped(
        b.add_virtual_targets(b.hasher.WIDTH), b.one()))
    b.register_public_input(b.mul_const_add(3, a, c))
    b.assert_zero(b.sub(a, a))
    b.connect(b.arithmetic(5, 0, a, c, c), b.arithmetic(5, 0, a, c, a))


@pytest.mark.parametrize("field", FIELDS)
def test_gadgets_match_jax_before_build(field):
    """The rows, their constants, the copy constraints, the constants'
    targets, the public inputs and the open slots the gadgets leave, on
    the port's builder and on the JAX one (no build)."""
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    jspec = jhost.GOLDILOCKS if field == "goldilocks" else jhost.BABYBEAR
    states = []
    for b in (CircuitBuilder(config_of(field), SPECS[field]),
              JCircuitBuilder(getattr(JCircuitConfig, PRESETS[field])(),
                              spec=jspec)):
        _gadget_circuit(b)
        states.append((
            [(i.gate.id(), i.constants) for i in b.gate_instances],
            b.copy_constraints, b.constants_to_targets, b.public_inputs,
            b.current_slots, b.virtual_target_index))
    assert states[0] == states[1]


def test_context_tree_matches_jax():
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    reports = []
    for b in (CircuitBuilder(config_of("goldilocks")),
              JCircuitBuilder(JCircuitConfig.standard_recursion_config_gl())):
        x = b.add_virtual_target()
        b.push_context("chain")
        for _ in range(50):
            x = b.mul_add(x, x, x)
        b.push_context("hash")
        b.hash_n_to_hash_no_pad([x] * 9)
        b.pop_context()
        b.pop_context()
        reports.append(b.print_gate_counts(0))
    assert reports[0] == reports[1]
    assert "2 gates to hash" in reports[0]


# --------------------------------------------------------------------------
# (b) the arithmetic chains built by the port against the JAX fixtures
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """(data, x, fixture arrays, fixture meta) of each field's 2^6 chain,
    built by the port on the CPU once per module."""
    cache = {}

    def get(field):
        if field not in cache:
            b = CircuitBuilder(config_of(field), SPECS[field])
            x = circuits.arith_chain(b, 6)
            data = b.build(device="cpu")
            arrays, meta = read_fixture(fixture_path(6, field))
            cache[field] = (data, x, arrays, meta)
        return cache[field]

    return get


@pytest.fixture(scope="module")
def witnessed(built):
    """(circuit with the witness of x = 3, the rng after witness
    generation) of each field, from ``NonRandomRng(1)``."""
    cache = {}

    def get(field):
        if field not in cache:
            data, x, _, _ = built(field)
            pw = PartialWitness()
            pw.set_target(x, 3)
            rng = NonRandomRng(1)
            cache[field] = (data.circuit(pw, rng), rng)
        return cache[field]

    return get


@pytest.mark.parametrize("field", FIELDS)
def test_built_constants_sigmas_match_jax(built, field):
    data, _, arrays, _ = built(field)
    np.testing.assert_array_equal(
        data.F.to_ints(data.prover_only.constants_sigmas_values),
        arrays["constants_sigmas"])


@pytest.mark.parametrize("field", FIELDS)
def test_built_cap_and_digest_match_jax(built, field):
    data, _, arrays, meta = built(field)
    np.testing.assert_array_equal(
        np.asarray(data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        arrays["constants_sigmas_cap"])
    assert data.verifier_only.circuit_digest == meta["circuit_digest"]
    assert data.prover_only.circuit_digest == meta["circuit_digest"]


@pytest.mark.parametrize("field", FIELDS)
def test_built_layout_matches_jax(built, field):
    """Gate ids, selector layout, k_is, partial products, random wire and
    every other metadata entry; the config is the preset."""
    data, _, _, meta = built(field)
    assert circuit_meta(data, field) == dict(meta, field=field)
    assert data.common.config == config_of(field)


@pytest.mark.parametrize("field", FIELDS)
def test_built_witness_matches_jax(witnessed, built, field):
    circuit, _ = witnessed(field)
    _, _, arrays, _ = built(field)
    np.testing.assert_array_equal(circuit.F.to_ints(circuit.wires),
                                  arrays["wires"])
    assert circuit.public_inputs == [int(v) for v in arrays["public_inputs"]]


@pytest.mark.parametrize("field,counter", [("goldilocks", 132),
                                           ("babybear", 171)])
def test_witness_generation_leaves_the_jax_counter(witnessed, field,
                                                   counter):
    """131 (GL) and 159 (BB) random wires drawn in the JAX order: the
    counter where the JAX retry fixture recorded it."""
    _, rng = witnessed(field)
    with np.load(fixture_path(6, field, retry=True)) as z:
        assert int(z["counter"]) == counter
    assert rng.counter == counter


@pytest.fixture(scope="module")
def built_proofs(witnessed):
    cache = {}

    def get(field):
        if field not in cache:
            circuit, _ = witnessed(field)
            cache[field] = flatten_proof(prover.prove(circuit, "cpu"))
        return cache[field]

    return get


@pytest.mark.parametrize("field,phase", [
    pytest.param(f, ph, id=f"{f}-{ph}") for f in FIELDS
    for ph in PROOF_PHASES])
def test_built_proof_phase_matches_jax(built, built_proofs, field, phase):
    _, _, arrays, _ = built(field)
    np.testing.assert_array_equal(built_proofs(field)[phase],
                                  arrays["proof_" + phase])


@pytest.fixture(scope="module")
def built_retries(built):
    """``CircuitData.prove`` of each field's chain from ``NonRandomRng(1)``
    with its first attempts made to fail, as the JAX retry fixture's were:
    (stored arrays, the proof flattened, the values found at the random
    wire by the later attempts)."""
    cache = {}

    def get(field):
        if field in cache:
            return cache[field]
        data, x, _, _ = built(field)
        with np.load(fixture_path(6, field, retry=True)) as z:
            arrays = {k: z[k] for k in z.files}
        failures, real, seen = len(arrays["values"]), \
            prover._internal_prove, []

        def internal_prove(circuit, wires, timings, rng):
            row, col = circuit.random_wire
            seen.append(int(circuit.F.to_ints(wires[col, row:row + 1])[0]))
            if len(seen) <= failures:
                raise prover.InvZeroPermArg()
            return real(circuit, wires, timings, rng)

        pw = PartialWitness()
        pw.set_target(x, 3)
        prover._internal_prove = internal_prove
        try:
            proof = data.prove(pw, rng=NonRandomRng(1))
        finally:
            prover._internal_prove = real
        cache[field] = (arrays, flatten_proof(proof), seen[1:])
        return cache[field]

    return get


@pytest.mark.parametrize("field", FIELDS)
def test_built_retry_redraws_the_jax_values(built_retries, field):
    arrays, _, values = built_retries(field)
    assert values == [int(v) for v in arrays["values"]]


@pytest.mark.parametrize("field,phase", [
    pytest.param(f, ph, id=f"{f}-{ph}") for f in FIELDS
    for ph in PROOF_PHASES])
def test_built_retry_proof_phase_matches_jax(built_retries, field, phase):
    arrays, flat, _ = built_retries(field)
    np.testing.assert_array_equal(flat[phase], arrays["proof_" + phase])


# --------------------------------------------------------------------------
# (c) the mixed circuit and the refusals
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    """(data, circuit with the witness of ``MIX_INPUTS``, the rng after
    witness generation, fixture arrays, fixture meta) of each field."""
    cache = {}

    def get(field):
        if field not in cache:
            b = CircuitBuilder(config_of(field), SPECS[field])
            inputs = circuits.builder_mix(b)
            data = b.build(device="cpu")
            pw = PartialWitness()
            pw.set_targets(inputs, circuits.MIX_INPUTS)
            rng = NonRandomRng(1)
            circuit = data.circuit(pw, rng)
            arrays, meta = read_fixture(mix_path(field))
            cache[field] = (data, circuit, rng, arrays, meta)
        return cache[field]

    return get


@pytest.mark.parametrize("field", FIELDS)
def test_mixed_commit_matches_jax(mixed, field):
    data, _, _, arrays, meta = mixed(field)
    np.testing.assert_array_equal(
        data.F.to_ints(data.prover_only.constants_sigmas_values),
        arrays["constants_sigmas"])
    np.testing.assert_array_equal(
        np.asarray(data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        arrays["constants_sigmas_cap"])
    assert data.verifier_only.circuit_digest == meta["circuit_digest"]


@pytest.mark.parametrize("field", FIELDS)
def test_mixed_layout_matches_jax(mixed, field):
    from plonky2_goldibear_torch.iop.generator import ConstantGenerator

    data, _, _, _, meta = mixed(field)
    assert circuit_meta(data, field) == meta
    assert meta["num_public_inputs"] == 12
    consts = [g for g in data.prover_only.generators
              if isinstance(g, ConstantGenerator)]
    assert len(consts) >= 5 and len({g.row for g in consts}) >= 2


@pytest.mark.parametrize("field", FIELDS)
def test_mixed_witness_matches_jax(mixed, field):
    _, circuit, rng, arrays, _ = mixed(field)
    np.testing.assert_array_equal(circuit.F.to_ints(circuit.wires),
                                  arrays["wires"])
    assert circuit.public_inputs == [int(v) for v in arrays["public_inputs"]]
    assert rng.counter == int(arrays["counter"])


def test_mul_by_one_returns_the_target():
    b = CircuitBuilder(config_of("goldilocks"))
    x = b.add_virtual_target()
    rows = b.num_gates()
    assert b.mul(x, b.one()) == x and b.mul(b.one(), x) == x
    assert b.num_gates() == rows


def test_unported_features_raise_with_their_item():
    """The streaming commit (item 9) raises; ``add_many`` of 23 addends
    and a set ``goal_common_data`` (item 4b) are ported: one AddManyGate
    op placed as the JAX builder places it, and a build whose common data
    differs from its goal refused."""
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    cfg = config_of("goldilocks")
    b = CircuitBuilder(cfg)
    x = b.add_virtual_target()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 9\\b"):
        b.build(device="cpu", commit_streaming=True)
    # the hashers are ported (the Keccak config was item 7): one the port
    # does not know is refused as unknown, in a gadget and as the builder's
    for call in (lambda: b.permute([x] * 12, hasher=object()),
                 lambda: CircuitBuilder(cfg, hasher=object())):
        with pytest.raises(ValueError, match="unknown hasher"):
            call()
    rows = []
    for bb in (CircuitBuilder(cfg),
               JCircuitBuilder(JCircuitConfig.standard_recursion_config_gl())):
        y = bb.add_virtual_target()
        s = bb.add_many([y] * 23)
        rows.append(([i.gate.id() for i in bb.gate_instances],
                     bb.copy_constraints, s))
    assert rows[0] == rows[1]
    assert rows[0][0] == ["AddManyGate { num_addends: 23, num_ops: 3 }"]
    b = CircuitBuilder(cfg)
    b.register_public_input(b.add_virtual_target())
    goal = CircuitBuilder(cfg).build_common()
    assert goal.num_public_inputs == 0
    b.goal_common_data = goal
    with pytest.raises(ValueError, match="goal_common_data"):
        b.build(device="cpu")


def test_keccak_builder_commits_with_keccak_and_hashes_with_poseidon():
    """Under the Keccak config the builder's gadgets, the recursive
    challenger included, place Poseidon-GL gates (the inner hasher), the
    rows equal the JAX Keccak builder's, and the build's cap and digest
    are bytes."""
    from plonky2_goldibear_torch.hash import keccak_hasher, poseidon_gl
    from plonky2_goldibear_torch.recursion.challenger import \
        RecursiveChallenger
    from plonky2_goldibear_tpu.hash import keccak_hasher as jkeccak
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig

    states = []
    for b in (CircuitBuilder(config_of("goldilocks"), hasher=keccak_hasher),
              JCircuitBuilder(JCircuitConfig.standard_recursion_config_gl(),
                              hasher=jkeccak)):
        _gadget_circuit(b)
        states.append((
            [(i.gate.id(), i.constants) for i in b.gate_instances],
            b.copy_constraints, b.constants_to_targets, b.public_inputs,
            b.current_slots, b.virtual_target_index))
    assert states[0] == states[1]
    b = CircuitBuilder(config_of("goldilocks"), hasher=keccak_hasher)
    assert b.hasher is keccak_hasher and b.inner_hasher is poseidon_gl
    ch = RecursiveChallenger(b)
    assert ch.hasher is poseidon_gl
    ch.observe_elements(b.add_virtual_targets(3))
    ch.get_challenge()
    assert [i.gate.id() for i in b.gate_instances] == \
        ["PoseidonGate<WIDTH=12>"]
    circuits.arith_chain(b, 4)
    data = b.build(device="cpu")
    assert data.hasher is keccak_hasher and data.inner_hasher is poseidon_gl
    assert isinstance(data.verifier_only.circuit_digest, bytes)
    assert all(isinstance(d, bytes) and len(d) == 25
               for d in data.verifier_only.constants_sigmas_cap)


def test_build_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    b = CircuitBuilder(config_of("goldilocks"))
    circuits.arith_chain(b, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.build()


def test_contradictory_assignment_raises(built):
    """The chain's end set to a value its generators contradict."""
    data, x, _, _ = built("goldilocks")
    pw = PartialWitness()
    pw.set_target(x, 3)
    pw.set_target(data.prover_only.public_inputs[1], 7)
    with pytest.raises(AssertionError, match="contradictory assignment"):
        data.circuit(pw, NonRandomRng(1))
    with pytest.raises(AssertionError, match="contradictory assignment"):
        pw.set_target(x, 4)


# --------------------------------------------------------------------------
# the mixed fixtures' writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def write_mix_fixture(field: str) -> None:
    """Build ``circuits.builder_mix`` with the JAX package, generate its
    witness of ``MIX_INPUTS`` under ``set_nonrandom(True)``, and write the
    constants/sigmas, cap, wires, public inputs, the counter after witness
    generation and the metadata to ``mix_path(field)``."""
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    from plonky2_goldibear_tpu.field import bb as jbb
    from plonky2_goldibear_tpu.field import fft as jfft
    from plonky2_goldibear_tpu.field import gl as jgl
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.iop import generator as gen
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig
    t0 = time.time()
    jF = jgl if field == "goldilocks" else jbb
    spec = jhost.GOLDILOCKS if field == "goldilocks" else jhost.BABYBEAR
    b = JCircuitBuilder(getattr(JCircuitConfig, PRESETS[field])(), spec=spec)
    inputs = circuits.builder_mix(b)
    data = b.build()
    common, po = data.common, data.prover_only
    pw = JPartialWitness()
    pw.set_targets(inputs, circuits.MIX_INPUTS)
    gen.set_nonrandom(True)
    part = gen.generate_partial_witness(pw, po, common)
    arrays = {
        "constants_sigmas": np.asarray(jF.to_ints(jfft.fft(
            jF, po.constants_sigmas_commitment.coeffs)), dtype=np.uint64),
        "constants_sigmas_cap": np.asarray(
            data.verifier_only.constants_sigmas_cap, dtype=np.uint64),
        "wires": part.full_witness(),
        "public_inputs": np.asarray(part.get_targets(po.public_inputs),
                                    dtype=np.uint64),
        "counter": np.asarray(gen._NONRANDOM_COUNTER, dtype=np.uint64),
    }
    path = mix_path(field)
    np.savez_compressed(path, meta=np.array(json.dumps(
        circuit_meta(data, field))), **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes) after "
          f"{time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the builder's mixed-circuit fixture from the JAX "
                    "package (or, without --write-fixtures, run these "
                    "tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    ap.add_argument("--field", choices=FIELDS, default="goldilocks")
    cli = ap.parse_args()
    if cli.write_fixtures:
        write_mix_fixture(cli.field)
    else:
        sys.exit(pytest.main([__file__, "-q"]))
