"""The port's Poseidon-GL hashing, Merkle trees and transcript against the
JAX package, bit for bit (tolerance zero: exact field arithmetic).

Inputs are made with numpy from a seed.  The JAX Pallas kernels run in
interpret mode, as tests/test_ops_kernels.py runs them.
"""

import jax
import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.field import gl as jgl
from plonky2_goldibear_tpu.hash import challenger as jchal
from plonky2_goldibear_tpu.hash import merkle as jmerkle
from plonky2_goldibear_tpu.hash import poseidon_gl as jpg

from plonky2_goldibear_torch.field import gl as tgl
from plonky2_goldibear_torch.hash import _poseidon_gl_constants as C
from plonky2_goldibear_torch.hash import challenger as tchal
from plonky2_goldibear_torch.hash import merkle as tmerkle
from plonky2_goldibear_torch.hash import poseidon_gl as tpg
from plonky2_goldibear_torch.ops import poseidon_gl as tK

torch.set_num_threads(1)
P = tgl.P


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _jref(fn, *arrays):
    out = jax.jit(fn)(*(jgl.from_ints(a) for a in arrays))
    return jgl.to_ints(out)


@pytest.fixture(scope="module")
def interpret():
    import plonky2_goldibear_tpu.ops.poseidon_gl as JK

    old = JK._INTERPRET
    JK._INTERPRET = True
    yield JK
    JK._INTERPRET = old


def test_permute_known_answers():
    inputs = np.array([iv for iv, _ in C.TEST_VECTORS], dtype=np.uint64)
    expected = np.array([ov for _, ov in C.TEST_VECTORS], dtype=np.uint64)
    np.testing.assert_array_equal(
        tgl.to_ints(tpg.permute(tgl.from_ints(inputs))), expected)
    for iv, ov in C.TEST_VECTORS:
        assert tpg.permute_host(iv) == list(ov)


def test_permute_matches_jax():
    x = _rand(1, (256, 12))
    x[0] = P - 1
    out = tgl.to_ints(tpg.permute(tgl.from_ints(x)))
    np.testing.assert_array_equal(out, _jref(jpg.permute, x))


def test_permute_matches_pallas_interpret(interpret):
    x = _rand(2, (256, 12))
    ref = jgl.to_ints(interpret.permute_cols(jgl.from_ints(x.T), tile=128))
    np.testing.assert_array_equal(
        tgl.to_ints(tpg.permute(tgl.from_ints(x))), ref.T)


def test_ragged_permute_batch():
    x = _rand(3, (2, 3, 12))        # 6 states: not a multiple of anything
    out = tgl.to_ints(tpg.permute(tgl.from_ints(x)))
    for idx in np.ndindex(2, 3):
        assert list(out[idx]) == tpg.permute_host([int(v) for v in x[idx]])


@pytest.mark.parametrize("length", [1, 8, 20])
def test_hash_no_pad_matches_jax(length):
    x = _rand(10 + length, (64, length))
    out = tgl.to_ints(tpg.hash_n_to_m_no_pad(tgl.from_ints(x), 4))
    np.testing.assert_array_equal(
        out, _jref(lambda a: jpg.hash_n_to_m_no_pad(a, 4), x))


def test_hash_no_pad_135_matches_jax_host():
    """Leaves of 135 = 16 * 8 + 7 elements (the wire commitment's), against
    the JAX package's host sponge (its device sponge at this length is
    covered by the interpret-mode kernel test below)."""
    x = _rand(11, (6, 135))
    out = tgl.to_ints(tpg.hash_n_to_m_no_pad(tgl.from_ints(x), 4))
    for i in range(6):
        assert list(out[i]) == jpg.hash_n_to_m_no_pad_host(
            [int(v) for v in x[i]], 4)


def test_hash_leaves_matches_pallas_interpret(interpret):
    """The leaf sponge on 256 rows of 135 = 16 * 8 + 7 elements."""
    x = _rand(20, (256, 135))
    ref = jgl.to_ints(interpret.hash_cols_no_pad(jgl.from_ints(x.T),
                                                 tile=128))
    np.testing.assert_array_equal(
        tgl.to_ints(tK.hash_leaves(tgl.from_ints(x))), ref.T)


def test_hash_many_outputs_and_noop():
    x = _rand(30, (3, 11))
    out = tgl.to_ints(tpg.hash_n_to_m_no_pad(tgl.from_ints(x), 10))
    for i in range(3):
        assert list(out[i]) == jpg.hash_n_to_m_no_pad_host(
            [int(v) for v in x[i]], 10)
    short = _rand(31, (5, 3))
    np.testing.assert_array_equal(
        tgl.to_ints(tpg.hash_or_noop(tgl.from_ints(short))),
        _jref(jpg.hash_or_noop, short))
    assert tpg.hash_no_pad_host([1, 2, 3, 4, 5]) == \
        jpg.hash_no_pad_host([1, 2, 3, 4, 5])


def test_two_to_one_matches_jax(interpret):
    a, b = _rand(40, (256, 4)), _rand(41, (256, 4))
    out = tgl.to_ints(tpg.two_to_one(tgl.from_ints(a), tgl.from_ints(b)))
    np.testing.assert_array_equal(out, _jref(jpg.two_to_one, a, b))
    ref = jgl.to_ints(interpret.two_to_one_cols(jgl.from_ints(a.T),
                                                jgl.from_ints(b.T)))
    np.testing.assert_array_equal(out, ref.T)


def test_build_levels_matches_jax():
    """2^9 leaves, cap height 4: every level and the sibling chains of a
    few leaves."""
    leaves = _rand(50, (1 << 9, 8))
    num_layers = 9 - 4
    ref = jax.jit(lambda a: jmerkle.build_levels(a, num_layers))(
        jgl.from_ints(leaves))
    tree = tmerkle.MerkleTree(tgl.from_ints(leaves), 4)
    assert len(tree.levels) == len(ref) == num_layers + 1
    for lv, rv in zip(tree.levels, ref):
        np.testing.assert_array_equal(tgl.to_ints(lv), jgl.to_ints(rv))
    jtree = jmerkle.MerkleTree(jgl.from_ints(leaves), 4, levels=ref)
    idx = [0, 1, 77, 300, 511]
    assert tree.prove_batch(idx) == jtree.prove_batch(idx)
    assert tree.leaf_batch(idx) == jtree.leaf_batch(idx)
    assert tree.cap_host() == jtree.cap_host()


def test_challenger_transcript_matches_jax():
    rng = np.random.default_rng(60)
    a, b = tchal.Challenger(), jchal.Challenger()
    for step in range(40):
        kind = step % 4
        if kind == 0:
            vals = [int(v) for v in rng.integers(0, P, size=int(
                rng.integers(1, 20)), dtype=np.uint64)]
            a.observe_elements(vals)
            b.observe_elements(vals)
        elif kind == 1:
            cap = [[int(v) for v in row] for row in _rand(step, (4, 4))]
            a.observe_cap(cap)
            b.observe_cap(cap)
        elif kind == 2:
            assert a.get_n_challenges(3) == b.get_n_challenges(3)
        else:
            assert a.get_extension_challenge() == b.get_extension_challenge()
    assert a.sponge_state == b.sponge_state
