"""The host form of every gate the port reads, ``eval_unfiltered(A, vars)``,
against the JAX package's, on the CPU, exact (no tolerance).

(a) Each of the 14 gates (the 12 of the reference's recursive-verifier
    circuit, ``ConstantGate`` and ``Poseidon2BabyBearGate``) at seeded
    random ``EvaluationVars`` at an extension point, over Goldilocks, and
    over BabyBear (D = 4) where the gate is generic: the port's
    ``HostExtAlgebra`` result equals the JAX package's.
(b) The prover's evaluation of Arithmetic, Constant, PublicInput, Noop
    (through ``DeviceBaseAlgebra``) and of the two Poseidon gates (their
    stacked forms), ``vanishing.gate_constraints_device`` on CPU tensors
    at one base-field point, equals ``HostBaseAlgebra`` at that point.
(c) The algebra forms of the hashers against their host permutations, and
    the host Merkle check against a tree the port built.
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

from plonky2_goldibear_torch.field import bb, gl, host  # noqa: E402
from plonky2_goldibear_torch.gates import gate_from_id  # noqa: E402
from plonky2_goldibear_torch.gates.base import (  # noqa: E402
    EvaluationVars, HostBaseAlgebra, HostExtAlgebra)
from plonky2_goldibear_torch.plonk import vanishing  # noqa: E402

torch.set_num_threads(1)
SPECS = {"goldilocks": host.GOLDILOCKS, "babybear": host.BABYBEAR}


def _jax_gates(field: str):
    """The JAX package's gates of ``field``: the 14 over Goldilocks, the 12
    generic ones and Poseidon2-BB over BabyBear."""
    from plonky2_goldibear_tpu.field import host as jhost
    from plonky2_goldibear_tpu.gates import access_gates as ja
    from plonky2_goldibear_tpu.gates import basic_gates as jb
    from plonky2_goldibear_tpu.gates import extension_gates as je
    from plonky2_goldibear_tpu.gates import reducing as jr
    from plonky2_goldibear_tpu.gates.coset_interpolation import \
        CosetInterpolationGate
    from plonky2_goldibear_tpu.gates.poseidon import PoseidonGate
    from plonky2_goldibear_tpu.gates.poseidon2_bb_gate import \
        Poseidon2BabyBearGate
    from plonky2_goldibear_tpu.gates.poseidon_mds import PoseidonMdsGate

    bb_ = field == "babybear"
    jspec = jhost.BABYBEAR if bb_ else jhost.GOLDILOCKS
    D = jspec.ext_degree
    gates = [
        jb.ArithmeticGate(10 if bb_ else 20), jb.ConstantGate(2),
        jb.PublicInputGate(jspec.num_hash_out_elts), jb.NoopGate(),
        je.ArithmeticExtensionGate(2 if bb_ else 10, D),
        je.MulExtensionGate(3 if bb_ else 13, D),
        jr.ReducingGate(7 if bb_ else 43, D),
        jr.ReducingExtensionGate(5 if bb_ else 32, D),
        ja.RandomAccessGate(4, 2 if bb_ else 4, 1 if bb_ else 2),
        ja.BaseSumGate(31 if bb_ else 63, 2),
        CosetInterpolationGate(3 if bb_ else 4, 4 if bb_ else 6, jspec),
    ]
    if bb_:
        gates.append(Poseidon2BabyBearGate(1))
    else:
        gates += [PoseidonMdsGate(D), PoseidonGate()]
    return jspec, gates


GATE_CASES = [(f, i) for f, n in (("goldilocks", 13), ("babybear", 12))
              for i in range(n)]


def _random_ext(rng, spec, n):
    return [tuple(int(v) for v in rng.integers(0, spec.p, spec.ext_degree,
                                                   dtype=np.uint64))
            for _ in range(n)]


@pytest.mark.parametrize("field,index", GATE_CASES,
                         ids=[f"{f}-{i}" for f, i in GATE_CASES])
def test_gate_host_form_matches_jax(field, index):
    from plonky2_goldibear_tpu.gates.base import EvaluationVars as JVars
    from plonky2_goldibear_tpu.gates.base import HostExtAlgebra as JA

    jspec, gates = _jax_gates(field)
    jgate = gates[index]
    spec = SPECS[field]
    gate = gate_from_id(jgate.id(), spec)
    assert gate.id() == jgate.id()
    assert (gate.num_wires(), gate.num_constants(), gate.degree(),
            gate.num_constraints()) == (jgate.num_wires(),
                                        jgate.num_constants(),
                                        jgate.degree(),
                                        jgate.num_constraints())
    rng = np.random.default_rng([index, spec.ext_degree])
    consts = _random_ext(rng, spec, gate.num_constants())
    wires = _random_ext(rng, spec, gate.num_wires())
    pi_hash = _random_ext(rng, spec, spec.num_hash_out_elts)
    got = gate.eval_unfiltered(HostExtAlgebra(spec),
                               EvaluationVars(consts, wires, pi_hash))
    want = jgate.eval_unfiltered(JA(jspec), JVars(consts, wires, pi_hash))
    assert len(got) == gate.num_constraints()
    assert [tuple(v) for v in got] == [tuple(v) for v in want]


def test_every_gate_of_the_reference_circuit_is_covered():
    """The 12 gate ids of ``gl_regression_common.bin`` are among the
    Goldilocks cases, with ConstantGate and Poseidon2-BB the 14."""
    from plonky2_goldibear_torch.plonk.serialization import \
        read_common_circuit_data
    common = read_common_circuit_data(open(os.path.join(
        ROOT, "tests", "data", "gl_regression_common.bin"), "rb").read())
    gl_gates = _jax_gates("goldilocks")[1]
    assert {g.id() for g in common.gates} <= {g.id() for g in gl_gates}
    kinds = {type(g).__name__ for g in gl_gates + _jax_gates("babybear")[1]}
    assert len(kinds) == 14, kinds


# the chains' gates: (field, index in ``_jax_gates``)
DEVICE_CASES = [("goldilocks", i) for i in (0, 1, 2, 3, 12)] + \
    [("babybear", i) for i in (0, 1, 2, 3, 11)]


@pytest.mark.parametrize("field,index", DEVICE_CASES,
                         ids=[f"{f}-{i}" for f, i in DEVICE_CASES])
def test_host_and_device_forms_agree(field, index):
    F = gl if field == "goldilocks" else bb
    spec = SPECS[field]
    gate = gate_from_id(_jax_gates(field)[1][index].id(), spec)
    rng = np.random.default_rng([index, 7])

    def draw(n):
        return [int(v) for v in rng.integers(0, spec.p, n, dtype=np.uint64)]

    consts, wires = draw(gate.num_constants()), draw(gate.num_wires())
    pi_hash = draw(spec.num_hash_out_elts)
    got = gate.eval_unfiltered(HostBaseAlgebra(spec),
                               EvaluationVars(consts, wires, pi_hash))

    def column(vals):
        return F.from_ints(np.asarray(vals, dtype=np.uint64).reshape(-1, 1),
                           "cpu")

    dev = vanishing.gate_constraints_device(
        F, gate, column(wires), column(consts),
        list(F.from_ints(pi_hash, "cpu").unbind(0)))
    want = [int(v) for v in F.to_ints(dev)[:, 0]]
    assert len(got) == gate.num_constraints()
    assert got == want


# --------------------------------------------------------------------------
# (c) the hashers' algebra forms and the host Merkle check
# --------------------------------------------------------------------------


@pytest.mark.parametrize("field", list(SPECS))
def test_algebra_permutation_matches_host(field):
    from plonky2_goldibear_torch.hash import poseidon2_bb, poseidon_gl
    spec = SPECS[field]
    rng = np.random.default_rng(5)
    A = HostBaseAlgebra(spec)
    width = 12 if field == "goldilocks" else 16
    for _ in range(4):
        st = [int(v) for v in rng.integers(0, spec.p, width, dtype=np.uint64)]
        if field == "goldilocks":
            assert poseidon_gl.permute_fast_a(A, st) == \
                poseidon_gl.permute_host(st)
        else:
            assert poseidon2_bb.permute_a(A, st) == \
                poseidon2_bb.permute_host(st)


@pytest.mark.parametrize("field", list(SPECS))
def test_host_merkle_check_accepts_the_tree_and_rejects_a_change(field):
    from plonky2_goldibear_torch.hash import merkle, poseidon2_bb, poseidon_gl
    F, hasher = (gl, poseidon_gl) if field == "goldilocks" else \
        (bb, poseidon2_bb)
    spec = SPECS[field]
    rng = np.random.default_rng(11)
    leaves = F.from_ints(rng.integers(0, spec.p, (64, 9), dtype=np.uint64),
                         "cpu")
    tree = merkle.MerkleTree(leaves, 2, hasher)
    cap = tree.cap_host()
    idx = [0, 17, 63]
    for i, leaf, sibs in zip(idx, tree.leaf_batch(idx),
                             tree.prove_batch(idx)):
        assert merkle.verify_merkle_proof_to_cap(leaf, i, cap, sibs, hasher)
        assert not merkle.verify_merkle_proof_to_cap(leaf, i ^ 1, cap, sibs,
                                                     hasher)
        leaf[3] = (leaf[3] + 1) % spec.p
        assert not merkle.verify_merkle_proof_to_cap(leaf, i, cap, sibs,
                                                     hasher)
