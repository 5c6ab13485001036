"""The port's Poseidon2-BabyBear hashing, Merkle trees, width-16 transcript
and Poseidon2BabyBearGate constraints against the JAX package, bit for bit
(tolerance zero: exact field arithmetic; Montgomery bit patterns compared
directly).

Inputs are made with numpy from a seed.  The JAX Pallas permutation runs
in interpret mode, as tests/test_ops_kernels.py runs it.
"""

import jax
import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.field import bb as jbb
from plonky2_goldibear_tpu.hash import challenger as jchal
from plonky2_goldibear_tpu.hash import merkle as jmerkle
from plonky2_goldibear_tpu.hash import poseidon2_bb as jp2

from plonky2_goldibear_torch.field import bb as tbb
from plonky2_goldibear_torch.hash import challenger as tchal
from plonky2_goldibear_torch.hash import merkle as tmerkle
from plonky2_goldibear_torch.hash import poseidon2_bb as tp2
from plonky2_goldibear_torch.ops import poseidon2_bb as tK

torch.set_num_threads(1)
P = tbb.P


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _mont(t):
    return t.numpy().astype(np.uint32)


def _jref(fn, *canon):
    out = jax.jit(fn)(*(jbb.from_ints(a) for a in canon))
    return np.asarray(out, dtype=np.uint32)


def test_permute_host_matches_jax():
    x = _rand(1, (8, 16))
    x[0] = 0
    x[1] = P - 1
    for row in x:
        s = [int(v) for v in row]
        assert tp2.permute_host(s) == jp2.permute_host(s)


def test_permute_matches_jax():
    x = _rand(2, (256, 16))
    np.testing.assert_array_equal(_mont(tp2.permute(tbb.from_ints(x))),
                                  _jref(jp2.permute, x))


def test_permute_matches_pallas_interpret():
    import plonky2_goldibear_tpu.ops.poseidon2_bb as JK2
    import plonky2_goldibear_tpu.ops.poseidon_gl as JK

    x = _rand(3, (256, 16))
    old = JK._INTERPRET
    JK._INTERPRET = True
    try:
        ref = np.asarray(JK2.permute_cols(jbb.from_ints(x).T)).T
    finally:
        JK._INTERPRET = old
    np.testing.assert_array_equal(_mont(tK.permute(tbb.from_ints(x))), ref)


def test_ragged_permute_batch():
    x = _rand(4, (2, 3, 16))        # 6 states: not a multiple of anything
    out = tbb.to_ints(tp2.permute(tbb.from_ints(x)))
    for idx in np.ndindex(2, 3):
        assert list(out[idx]) == jp2.permute_host([int(v) for v in x[idx]])


@pytest.mark.parametrize("length", [1, 8, 20, 32])
def test_hash_no_pad_matches_jax(length):
    x = _rand(10 + length, (64, length))
    np.testing.assert_array_equal(
        _mont(tp2.hash_n_to_m_no_pad(tbb.from_ints(x), 8)),
        _jref(lambda a: jp2.hash_n_to_m_no_pad(a, 8), x))


def test_hash_no_pad_167_matches_jax_host():
    """Leaves of 167 = 20 * 8 + 7 elements (the wire commitment's: 21
    absorbs), against the JAX package's host sponge."""
    x = _rand(11, (4, 167))
    out = tbb.to_ints(tp2.hash_n_to_m_no_pad(tbb.from_ints(x), 8))
    for i in range(4):
        assert list(out[i]) == jp2.hash_n_to_m_no_pad_host(
            [int(v) for v in x[i]], 8)


def test_hash_many_outputs_and_noop():
    x = _rand(30, (3, 11))
    out = tbb.to_ints(tp2.hash_n_to_m_no_pad(tbb.from_ints(x), 20))
    for i in range(3):
        assert list(out[i]) == jp2.hash_n_to_m_no_pad_host(
            [int(v) for v in x[i]], 20)
    short = _rand(31, (5, 3))
    np.testing.assert_array_equal(
        _mont(tp2.hash_or_noop(tbb.from_ints(short))),
        _jref(jp2.hash_or_noop, short))
    assert tp2.hash_no_pad_host(list(range(1, 20))) == \
        jp2.hash_no_pad_host(list(range(1, 20)))


def test_two_to_one_matches_jax():
    a, b = _rand(40, (64, 8)), _rand(41, (64, 8))
    np.testing.assert_array_equal(
        _mont(tp2.two_to_one(tbb.from_ints(a), tbb.from_ints(b))),
        _jref(jp2.two_to_one, a, b))


def test_merkle_tree_matches_jax():
    """2^8 leaves of 32 elements (a FRI round's arity 8 x D 4), cap height
    4: every level, the cap and the sibling chains of a few leaves."""
    leaves = _rand(50, (1 << 8, 32))
    ref = jax.jit(lambda a: jmerkle.build_levels(a, 8 - 4, jp2))(
        jbb.from_ints(leaves))
    jtree = jmerkle.MerkleTree(jbb.from_ints(leaves), 4, hasher=jp2,
                               levels=ref)
    tree = tmerkle.MerkleTree(tbb.from_ints(leaves), 4, hasher=tp2)
    assert len(tree.levels) == len(jtree.levels) == 8 - 4 + 1
    for lv, rv in zip(tree.levels, jtree.levels):
        np.testing.assert_array_equal(_mont(lv), np.asarray(rv))
    idx = [0, 1, 77, 200, 255]
    assert tree.cap_host() == jtree.cap_host()
    assert tree.prove_batch(idx) == jtree.prove_batch(idx)
    assert tree.leaf_batch(idx) == jtree.leaf_batch(idx)


def test_merkle_levels_plain_matches_wrapper():
    d = tbb.from_ints(_rand(51, (1 << 6, 8)))
    got = tK.merkle_levels(d, 6)
    ref = tK.merkle_levels_plain(d, 6)
    assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, ref))


def test_challenger_transcript_matches_jax():
    from plonky2_goldibear_torch.field.host import BABYBEAR

    rng = np.random.default_rng(60)
    a = tchal.Challenger(BABYBEAR, tp2)
    b = jchal.Challenger(permute=jp2.permute_host, width=16, rate=8,
                         spec=jp2.BABYBEAR)
    for step in range(40):
        kind = step % 4
        if kind == 0:
            vals = [int(v) for v in rng.integers(0, P, size=int(
                rng.integers(1, 20)), dtype=np.uint64)]
            a.observe_elements(vals)
            b.observe_elements(vals)
        elif kind == 1:
            cap = [[int(v) for v in row] for row in _rand(step, (4, 8))]
            a.observe_cap(cap)
            b.observe_cap(cap)
        elif kind == 2:
            assert a.get_n_challenges(3) == b.get_n_challenges(3)
        else:
            assert a.get_extension_challenge() == b.get_extension_challenge()
    assert a.sponge_state == b.sponge_state


def test_poseidon2_bb_gate_constraints_match_jax():
    """The gate's 150 constraints on random wires (167 x 64 points), against
    the JAX gate's ``eval_unfiltered_device``."""
    from plonky2_goldibear_tpu.gates.poseidon2_bb_gate import \
        Poseidon2BabyBearGate as JGate

    from plonky2_goldibear_torch.gates import gate_from_id

    jgate = JGate(1)
    gate = gate_from_id(jgate.id())
    assert gate.num_constraints() == jgate.num_constraints() == 150
    wires = _rand(70, (167, 64))
    wires[33, :8] = [0, 1, 0, 1, 0, 1, 1, 0]     # swap flags, mostly random
    ref = jax.jit(lambda w: jax.numpy.stack(
        jgate.eval_unfiltered_device(jbb, w, None)))(jbb.from_ints(wires))
    got = gate.eval_unfiltered_device(tbb, tbb.from_ints(wires), None, None)
    np.testing.assert_array_equal(_mont(got), np.asarray(ref))
