"""Conditional and cyclic (IVC) recursion in the port, against the JAX
package, on the CPU, exact (tolerance zero: rows, common data, caps,
digests, witness columns and proofs compared with equality).

(a) The dummy circuit (``recursion/conditional.py:dummy_circuit``) over
    the common data of ``circuits.fib_inner`` under
    ``standard_recursion_config_gl()`` with one FRI query round and 8 PoW
    bits (``small_config``: the CPU's grind of a 16-bit PoW witness takes
    tens of seconds a proof): the inner's and the dummy's builds (common
    data, cap, digest) against the JAX bytes, and both proofs from
    ``NonRandomRng(1)`` against the JAX proofs, bit for bit.  The card
    holds both proofs at the full config against the JAX proofs
    (``chip_smoke.py`` phase 10).
(b) The conditional outer (``circuits.conditional_outer``: a boolean and
    ``conditionally_verify_proof_or_dummy``) over ``fib_inner``: laid out
    by both builders before ``build`` (live) at the full config and at
    ``small_config`` (2^10 rows, where the full config gives 2^12 and a
    CPU commit of a minute); at ``small_config`` the port's build against
    ``data/conditional_outer_1q_{common,verifier}.bin``, and its witness of
    the JAX inner proof for condition 1 and condition 0 (the dummy branch)
    against a SHA-256 of every JAX wire column
    (``conditional_outer_1q.npz``).  The dummy proof is made while the
    gadgets are laid out, from ``NonRandomRng(1)`` as the JAX writer's
    from its reset counter; a generator without dependencies hands it to
    the witness.
(c) The IVC fixed point (``common_data_for_recursion``): the reference's
    helper pads the second wrap to 1 << 12 gates, so the counter circuit
    (``circuits.cyclic_counter``) has 2^13 rows; against the same
    construction by the JAX builder (``cyclic_common.bin``).  The same
    construction with other padding (``_cyclic_common``): unpadded against
    the JAX package's own ``common_data_for_recursion``
    (``cyclic_common_jax.bin``, 2^12 rows, which the counter does not
    fit), and at ``small_config`` padded to 1 << 10 gates (2^11 rows).
    The counter circuit at the full config laid out against the JAX bytes
    and its goal; at ``small_config`` built, committed and checked against
    the JAX build.  Both builds
    run with a stand-in for the dummy proof, as the JAX writer's do: its
    values reach the circuit only at witness time.
(d) The helpers: the verifier data read from the public inputs, a
    tampered copy refused, the base proof's public inputs, a build that
    misses its goal refused.

The whole IVC (base case and two steps, proved and verified) runs on the
card: ``chip_smoke.py`` phase 10.  The fixtures are written by the JAX
package on the CPU with

    python tests/test_torch_conditional_recursion.py --write-fixtures
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from plonky2_goldibear_torch import circuits  # noqa: E402
from plonky2_goldibear_torch.field import host  # noqa: E402
from plonky2_goldibear_torch.gates.basic_gates import NoopGate  # noqa: E402
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.plonk import gadgets as gd  # noqa: E402
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import (  # noqa: E402
    DATA_DIR, VerifierOnlyCircuitData)
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.plonk.proof import (  # noqa: E402
    PROOF_PHASES, flatten_proof)
from plonky2_goldibear_torch.plonk.verifier import \
    VerificationError  # noqa: E402
from plonky2_goldibear_torch.recursion import \
    conditional as cc  # noqa: E402
from plonky2_goldibear_torch.recursion import \
    recursive_verifier as rv  # noqa: E402

torch.set_num_threads(1)
P = host.GOLDILOCKS.p
SMALL_QUERIES = 1
SMALL_POW_BITS = 8
# the goal's gates at one query round: 2^11 rows, the counter's 887 gates
# and its constants fit
SMALL_CYCLIC_GATES = 1 << 10
OUTER = "conditional_outer_1q"


def full_config(C=CircuitConfig):
    return C.standard_recursion_config_gl()


def small_config(C=CircuitConfig):
    """One FRI query round and 8 PoW bits: the CPU's grind of a 16-bit
    witness takes tens of seconds."""
    cfg = C.standard_recursion_config_gl()
    return dataclasses.replace(cfg, fri_config=dataclasses.replace(
        cfg.fri_config, num_query_rounds=SMALL_QUERIES,
        proof_of_work_bits=SMALL_POW_BITS))


def data_path(name: str) -> str:
    return os.path.join(DATA_DIR, name)


def read_bin(name: str) -> bytes:
    with open(data_path(name + ".bin"), "rb") as f:
        return f.read()


def jax_common(name):
    return ser.read_common_circuit_data(read_bin(name + "_common"))


def jax_vk(name):
    return ser.read_verifier_only_circuit_data(read_bin(name + "_verifier"))


def jax_proof(name):
    return ser.read_proof_with_public_inputs(read_bin(name + "_proof"),
                                             jax_common(name))


def column_digests(wires: np.ndarray) -> np.ndarray:
    """A SHA-256 of each wire column (num_wires, 32) uint8."""
    return np.stack([np.frombuffer(hashlib.sha256(
        np.ascontiguousarray(col, dtype=np.uint64).tobytes()).digest(),
        dtype=np.uint8) for col in wires])


def _state(b):
    return ([(i.gate.id(), i.constants) for i in b.gate_instances],
            b.copy_constraints, b.constants_to_targets, b.public_inputs,
            b.current_slots, b.virtual_target_index)


def _jax_modules():
    from plonky2_goldibear_tpu.plonk import gadgets as jgd
    from plonky2_goldibear_tpu.plonk.builder import \
        CircuitBuilder as JCircuitBuilder
    from plonky2_goldibear_tpu.plonk.config import \
        CircuitConfig as JCircuitConfig
    from plonky2_goldibear_tpu.recursion import conditional as jcc
    from plonky2_goldibear_tpu.recursion import \
        recursive_verifier as jrv

    return JCircuitBuilder, JCircuitConfig, jcc, jrv, jgd


def _stand_in_proof(circuit, nonzero_public_inputs, rng=None):
    """In place of the dummy proof: the circuit's layout does not depend
    on its values, which reach the circuit only at witness time."""
    return None


def _stand_in_circuit(common, device=None):
    return types.SimpleNamespace(verifier_only=None)


def _cyclic_common(config, num_gates, B=CircuitBuilder, rv=rv,
                   noop=NoopGate, common_of=CircuitBuilder.build_common):
    """``cc.common_data_for_recursion`` with the second wrap padded to
    ``num_gates`` gates, by the builder ``B`` with its package's
    recursive verifier ``rv`` and NoopGate ``noop``; ``common_of(b)``
    lays a builder's circuit out (the JAX package: ``b.build().common``)."""
    common = common_of(B(config))
    for wrap in range(2):
        b = B(config)
        proof_t = rv.add_virtual_proof_with_pis(b, common)
        vk_t = rv.add_virtual_verifier_data(
            b, common.config.fri_config.cap_height)
        rv.verify_proof(b, proof_t, vk_t, common)
        if wrap == 1:
            while b.num_gates() < num_gates:
                b.add_gate(noop(), [])
        common = common_of(b)
    return common


# --------------------------------------------------------------------------
# (a) fib_inner and the dummy circuit over its common data
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fib():
    """(data, proof from NonRandomRng(1)) of ``fib_inner`` at
    ``small_config``, the port on the CPU."""
    b = CircuitBuilder(small_config())
    ins = circuits.fib_inner(b)
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_targets(ins, circuits.FIB_INNER_INPUTS)
    return data, data.prove(pw, rng=NonRandomRng(1))


@pytest.fixture(scope="module")
def dummy(fib):
    """(data, proof from NonRandomRng(1)) of the dummy circuit over
    ``fib_inner``'s common data at ``small_config``, the port on the
    CPU."""
    data = cc.dummy_circuit(fib[0].common, device="cpu")
    return data, cc.dummy_proof(data, {}, rng=NonRandomRng(1))


def test_fib_inner_build_matches_jax(fib):
    data = fib[0]
    assert data.common == jax_common("fib_inner_1q")
    assert data.verifier_only == jax_vk("fib_inner_1q")


@pytest.mark.parametrize("phase", PROOF_PHASES)
def test_fib_inner_proof_matches_jax_bit_for_bit(fib, phase):
    np.testing.assert_array_equal(flatten_proof(fib[1])[phase],
                                  flatten_proof(jax_proof("fib_inner_1q"))[phase])


def test_fib_inner_proof_is_fibonacci(fib):
    a, b = circuits.FIB_INNER_INPUTS
    for _ in range(circuits.FIB_INNER_STEPS):
        a, b = b, (a + b) % P
    assert fib[1].public_inputs == [*circuits.FIB_INNER_INPUTS, a]


def test_dummy_circuit_build_matches_jax(fib, dummy):
    data = dummy[0]
    assert data.common == fib[0].common == jax_common("dummy_fib_1q")
    assert data.verifier_only == jax_vk("dummy_fib_1q")
    assert data.verifier_only != fib[0].verifier_only


@pytest.mark.parametrize("phase", PROOF_PHASES)
def test_dummy_proof_matches_jax_bit_for_bit(dummy, phase):
    np.testing.assert_array_equal(flatten_proof(dummy[1])[phase],
                                  flatten_proof(jax_proof("dummy_fib_1q"))[phase])


def test_dummy_proof_verifies_with_zero_public_inputs(fib, dummy):
    data, proof = dummy
    data.verify(proof)
    assert proof.public_inputs == [0, 0, 0]
    with pytest.raises(VerificationError):
        fib[0].verify(proof)


def test_dummy_circuit_of_other_common_data_is_refused(fib):
    common = copy.deepcopy(fib[0].common)
    common.num_constants += 1
    with pytest.raises(ValueError, match="goal_common_data"):
        cc.dummy_circuit(common, device="cpu")


# --------------------------------------------------------------------------
# (b) the conditional outer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("config, inner_name", (
    (full_config, "fib_inner"), (small_config, "fib_inner_1q")))
def test_conditional_outer_matches_jax_before_build(monkeypatch, config,
                                                    inner_name):
    """Both builders lay the outer out alike: the selects of every proof
    element in the proof's order, then the recursive verifier (the dummy
    circuits stood in on both sides: they place no rows in the outer)."""
    JB, JC, jcc, jrv, jgd = _jax_modules()
    inner = jax_common(inner_name)
    states = []
    for b, mods in ((CircuitBuilder(config()), (cc, rv, gd)),
                    (JB(config(JC)), (jcc, jrv, jgd))):
        monkeypatch.setattr(mods[0], "dummy_circuit", _stand_in_circuit)
        monkeypatch.setattr(mods[0], "dummy_proof", _stand_in_proof)
        circuits.conditional_outer(b, inner, *mods)
        states.append(_state(b))
    assert states[0] == states[1]


@pytest.fixture(scope="module")
def outer():
    """(data, condition target, proof targets, vk targets, timings) of the
    conditional outer over ``fib_inner`` at one query round, built by the
    port on the CPU."""
    b = CircuitBuilder(small_config())
    timings = {}
    cond, proof_t, vk_t = circuits.conditional_outer(
        b, jax_common("fib_inner_1q"), cc, rv, gd, device="cpu",
        rng=NonRandomRng(1), timings=timings)
    return b.build(device="cpu"), cond, proof_t, vk_t, timings


def test_conditional_outer_build_matches_jax(outer):
    data = outer[0]
    assert data.common == jax_common(OUTER)
    assert data.verifier_only == jax_vk(OUTER)
    assert data.common.degree_bits == 10
    assert outer[4]["dummy_s"] > 0


@pytest.mark.parametrize("condition", (1, 0))
def test_conditional_outer_witness_matches_jax(outer, condition):
    """The witness of the JAX inner proof under condition 1 (the proof is
    verified) and 0 (the dummy proof is), column by column."""
    data, cond, proof_t, vk_t, _ = outer
    pw = PartialWitness()
    pw.set_target(cond, condition)
    rv.set_proof_with_pis_target(pw, proof_t, jax_proof("fib_inner_1q"))
    rv.set_verifier_data_target(pw, vk_t, jax_vk("fib_inner_1q"))
    rng = NonRandomRng(1)
    circuit = data.circuit(pw, rng)
    with np.load(data_path(OUTER + ".npz")) as z:
        want = z[f"column_sha256_c{condition}"]
        pis = z[f"public_inputs_c{condition}"]
        counter = int(z[f"counter_c{condition}"])
    got = column_digests(circuit.F.to_ints(circuit.wires))
    bad = [c for c in range(len(want))
           if not np.array_equal(got[c], want[c])]
    assert not bad, f"wire columns {bad} differ from the JAX witness"
    assert circuit.public_inputs == [int(v) for v in pis] == []
    assert rng.counter == counter


def test_conditional_outer_refuses_a_non_boolean_condition(outer):
    data, cond, proof_t, vk_t, _ = outer
    pw = PartialWitness()
    pw.set_target(cond, 2)
    rv.set_proof_with_pis_target(pw, proof_t, jax_proof("fib_inner_1q"))
    rv.set_verifier_data_target(pw, vk_t, jax_vk("fib_inner_1q"))
    with pytest.raises(AssertionError):
        data.circuit(pw, NonRandomRng(1))


# --------------------------------------------------------------------------
# (c) the IVC fixed point and the counter circuit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name, make", (
    ("cyclic_common", lambda: cc.common_data_for_recursion(full_config())),
    ("cyclic_common_jax", lambda: _cyclic_common(full_config(), 0)),
    ("cyclic_common_1q",
     lambda: _cyclic_common(small_config(), SMALL_CYCLIC_GATES))),
    ids=("reference", "unpadded", "one_query"))
def test_common_data_for_recursion_matches_jax(name, make):
    common = make()
    assert common == ser.read_common_circuit_data(read_bin(name))
    assert common.num_public_inputs == 0


def test_common_data_for_recursion_degrees():
    common = cc.common_data_for_recursion(full_config())
    assert common.degree_bits == 13
    assert common == _cyclic_common(full_config(), 1 << 12)
    assert _cyclic_common(full_config(), 0).degree_bits == 12


def test_cyclic_counter_matches_jax_before_build(monkeypatch):
    JB, JC, jcc, jrv, _ = _jax_modules()
    states = []
    for b, mods in ((CircuitBuilder(full_config()), (cc, rv)),
                    (JB(full_config(JC)), (jcc, jrv))):
        monkeypatch.setattr(mods[0], "dummy_circuit", _stand_in_circuit)
        monkeypatch.setattr(mods[0], "dummy_proof", _stand_in_proof)
        circuits.cyclic_counter(b, jax_common("cyclic_counter"), *mods)
        states.append(_state(b))
    assert states[0] == states[1]
    assert len(states[0][0]) == 5723


def test_cyclic_counter_lays_out_to_its_goal(monkeypatch):
    """The full-config counter circuit's common data equals its goal and
    the JAX build's (its cap and digest are checked on the card)."""
    monkeypatch.setattr(cc, "dummy_circuit", _stand_in_circuit)
    monkeypatch.setattr(cc, "dummy_proof", _stand_in_proof)
    b = CircuitBuilder(full_config())
    common = cc.common_data_for_recursion(full_config())
    circuits.cyclic_counter(b, common, cc, rv)
    assert common.num_public_inputs == 9 + 4 + 4 * 16
    assert b.goal_common_data is common
    assert b.build_common() == common == jax_common("cyclic_counter")


def test_cyclic_counter_build_matches_jax(monkeypatch):
    """At one query round the counter circuit is built and committed to
    its goal, equal to the JAX build (the dummy circuit stood in: phase 10
    of ``chip_smoke.py`` builds and proves it at the full config)."""
    monkeypatch.setattr(cc, "dummy_circuit", _stand_in_circuit)
    monkeypatch.setattr(cc, "dummy_proof", _stand_in_proof)
    b = CircuitBuilder(small_config())
    common = _cyclic_common(small_config(), SMALL_CYCLIC_GATES)
    circuits.cyclic_counter(b, common, cc, rv, device="cpu")
    data = b.build(device="cpu")
    assert data.common == common == jax_common("cyclic_counter_1q")
    assert data.common.degree_bits == 11
    assert data.verifier_only == jax_vk("cyclic_counter_1q")


# --------------------------------------------------------------------------
# (d) the helpers
# --------------------------------------------------------------------------


def _vk_proof(common, vk, head=(0, 1, 2, 3, 4, 5, 6, 7, 8)):
    """A proof stand-in whose public inputs end in ``vk``."""
    flat = list(vk.circuit_digest) + [x for h in vk.constants_sigmas_cap
                                      for x in h]
    return types.SimpleNamespace(public_inputs=list(head) + flat)


def test_vk_from_public_inputs_reads_the_tail():
    common, vk = jax_common("cyclic_counter_1q"), jax_vk("cyclic_counter_1q")
    proof = _vk_proof(common, vk)
    assert len(proof.public_inputs) == common.num_public_inputs
    digest, cap = cc.vk_from_public_inputs(proof.public_inputs, common)
    assert digest == vk.circuit_digest and cap == vk.constants_sigmas_cap
    cc.check_cyclic_proof_verifier_data(proof, vk, common)


@pytest.mark.parametrize("index", (9, 12, 13, 40, 76))
def test_check_cyclic_proof_verifier_data_refuses_a_tampered_copy(index):
    common, vk = jax_common("cyclic_counter_1q"), jax_vk("cyclic_counter_1q")
    proof = _vk_proof(common, vk)
    proof.public_inputs[index] = (proof.public_inputs[index] + 1) % P
    with pytest.raises(ValueError, match="verifier"):
        cc.check_cyclic_proof_verifier_data(proof, vk, common)


def test_cyclic_base_proof_puts_the_vk_last(monkeypatch):
    """The base proof's public inputs: the given ones, zeros, then the
    cyclic circuit's verifier data (the dummy proof's inputs recorded)."""
    common, vk = jax_common("cyclic_counter_1q"), jax_vk("cyclic_counter_1q")
    seen = {}
    monkeypatch.setattr(cc, "dummy_circuit", _stand_in_circuit)
    monkeypatch.setattr(cc, "dummy_proof",
                        lambda c, pis, rng=None: seen.update(pis))
    cc.cyclic_base_proof(common, vk, dict(enumerate(
        circuits.CYCLIC_INITIAL_HASH)), device="cpu")
    pis = [seen.get(i, 0) for i in range(common.num_public_inputs)]
    assert pis[:9] == [*circuits.CYCLIC_INITIAL_HASH, 0, 0, 0, 0, 0]
    cc.check_cyclic_proof_verifier_data(
        types.SimpleNamespace(public_inputs=pis), vk, common)


def test_verifier_data_public_inputs_are_registered_once():
    b = CircuitBuilder(full_config())
    vk = cc.add_verifier_data_public_inputs(b)
    assert isinstance(vk, VerifierOnlyCircuitData)
    assert b.public_inputs == vk.circuit_digest + [
        t for h in vk.constants_sigmas_cap for t in h]
    with pytest.raises(ValueError, match="already"):
        cc.add_verifier_data_public_inputs(b)


def test_cyclic_recursion_needs_the_verifier_data_first():
    b = CircuitBuilder(full_config())
    common = jax_common("cyclic_counter_1q")
    with pytest.raises(ValueError, match="add_verifier_data_public_inputs"):
        cc.conditionally_verify_cyclic_proof_or_dummy(
            b, b.add_virtual_target(),
            rv.add_virtual_proof_with_pis(b, common), common)


def test_build_missing_its_goal_is_refused():
    b = CircuitBuilder(full_config())
    circuits.fib_inner(b)
    b.goal_common_data = jax_common("dummy_fib")
    b.goal_common_data.num_public_inputs += 1
    with pytest.raises(ValueError, match="goal_common_data"):
        b.build_common()


# --------------------------------------------------------------------------
# the fixtures' writer (JAX side; run as a script)
# --------------------------------------------------------------------------


def write_fixtures(only=None) -> None:
    """With the JAX package on the CPU: ``fib_inner`` and the dummy
    circuit over its common data at both configs (builds and sync proofs
    under ``set_nonrandom(True)``); the conditional outer over
    ``fib_inner`` at ``small_config`` (its dummy proof from the reset counter; its
    witness for both conditions); the IVC fixed points; the counter
    circuit's builds at both configs, the dummy proof replaced by a
    stand-in in this process only (the JAX package is not edited: a 2^13
    JAX prove on the CPU would take hours).  ``only``: "full" or "small",
    the fixtures of that config alone."""
    import time

    from test_torch_zk import _jax_setup

    _jax_setup()
    from plonky2_goldibear_tpu.iop import generator as gen
    from plonky2_goldibear_tpu.iop.witness import \
        PartialWitness as JPartialWitness
    from plonky2_goldibear_tpu.plonk import serialization as jser
    from plonky2_goldibear_tpu.utils.timing import ProvingProcessInfo

    JB, JC, jcc, jrv, jgd = _jax_modules()
    t0 = time.time()

    def write_bins(name, data=None, common=None, proof=None):
        common = data.common if data is not None else common
        parts = [("common", jser.write_common_circuit_data(common))]
        if data is not None:
            parts.append(("verifier", jser.write_verifier_only_circuit_data(
                data.verifier_only, common.spec)))
        if proof is not None:
            parts.append(("proof", jser.write_proof_with_public_inputs(
                proof, common)))
        for part, blob in parts:
            suffix = "" if data is None else f"_{part}"
            with open(data_path(f"{name}{suffix}.bin"), "wb") as f:
                f.write(blob)
        print(f"wrote {name} (2^{common.degree_bits} rows) after "
              f"{time.time() - t0:.0f} s", flush=True)

    def prove_bins(name, data, pw):
        gen.set_nonrandom(True)
        proof = data.prove(pw, timing=ProvingProcessInfo("prove"))
        data.verify(proof)
        write_bins(name, data, proof=proof)
        return proof

    configs = {"full": full_config(JC), "small": small_config(JC)}
    if only:
        configs = {only: configs[only]}
    for name, config in (("fib_inner", configs.get("full")),
                         ("fib_inner_1q", configs.get("small"))):
        if config is None:
            continue
        b = JB(config)
        ins = circuits.fib_inner(b)
        fib = b.build()
        pw = JPartialWitness()
        pw.set_targets(ins, circuits.FIB_INNER_INPUTS)
        inner_proof = prove_bins(name, fib, pw)
        dummy = jcc.dummy_circuit(fib.common)
        pw = JPartialWitness()
        for t in dummy.prover_only.public_inputs:
            pw.set_target(t, 0)
        prove_bins(name.replace("fib_inner", "dummy_fib"), dummy, pw)

    if "small" not in configs:
        return write_cyclic(JB, jcc, jrv, configs, write_bins)
    gen.set_nonrandom(True)
    b = JB(configs["small"])
    cond, proof_t, vk_t = circuits.conditional_outer(
        b, fib.common, jcc, jrv, jgd)
    outer = b.build()
    write_bins(OUTER, outer)
    arrays = {}
    for condition in (1, 0):
        pw = JPartialWitness()
        pw.set_target(cond, condition)
        jrv.set_proof_with_pis_target(pw, proof_t, inner_proof)
        jrv.set_verifier_data_target(pw, vk_t, fib.verifier_only)
        gen.set_nonrandom(True)
        part = gen.generate_partial_witness(pw, outer.prover_only,
                                            outer.common)
        arrays[f"column_sha256_c{condition}"] = column_digests(
            part.full_witness())
        arrays[f"public_inputs_c{condition}"] = np.asarray(
            part.get_targets(outer.prover_only.public_inputs), np.uint64)
        arrays[f"counter_c{condition}"] = np.asarray(
            int(gen._NONRANDOM_COUNTER), np.uint64)
    np.savez_compressed(data_path(OUTER + ".npz"), **arrays)
    print(f"wrote the outer's witnesses after {time.time() - t0:.0f} s",
          flush=True)

    write_cyclic(JB, jcc, jrv, configs, write_bins)


def write_cyclic(JB, jcc, jrv, configs, write_bins) -> None:
    """The IVC fixed points and the counter circuit's builds of the
    writer's ``configs``, the JAX dummy proof stood in."""
    if "full" in configs:
        write_bins("cyclic_common_jax",
                   common=jcc.common_data_for_recursion(configs["full"]))
    from plonky2_goldibear_tpu.gates.basic_gates import NoopGate as JNoopGate

    jcc.dummy_proof = _stand_in_proof
    for name, key, num_gates in (
            ("cyclic_counter", "full", 1 << 12),
            ("cyclic_counter_1q", "small", SMALL_CYCLIC_GATES)):
        if key not in configs:
            continue
        config = configs[key]
        common = _cyclic_common(config, num_gates, JB, jrv, JNoopGate,
                                lambda b: b.build().common)
        write_bins(name.replace("counter", "common"), common=common)
        b = JB(config)
        circuits.cyclic_counter(b, common, jcc, jrv)
        data = b.build()
        assert data.common == common
        write_bins(name, data)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the conditional and cyclic recursion fixtures "
                    "from the JAX package (or, without --write-fixtures, "
                    "run these tests).")
    ap.add_argument("--write-fixtures", action="store_true")
    ap.add_argument("--only", choices=("full", "small"),
                    help="the fixtures of one config alone")
    cli = ap.parse_args()
    if cli.write_fixtures:
        write_fixtures(cli.only)
    else:
        sys.exit(pytest.main([__file__, "-q"]))
