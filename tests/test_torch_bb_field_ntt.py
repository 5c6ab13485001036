"""The port's BabyBear field, bb4 and NTT against the JAX package, bit for
bit: both sides store Montgomery forms, and the stored bit patterns are
compared directly (tolerance zero: exact field arithmetic).

Inputs are made with numpy from a seed and handed to both sides.  The JAX
BabyBear NTT kernel runs in interpret mode, as tests/test_ops_kernels.py
runs it.
"""

import jax
import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.field import bb as jbb
from plonky2_goldibear_tpu.field import ext as jext
from plonky2_goldibear_tpu.field import fft as jfft

from plonky2_goldibear_torch.field import bb as tbb
from plonky2_goldibear_torch.field import ext as text
from plonky2_goldibear_torch.field import fft as tfft
from plonky2_goldibear_torch.ops import ntt_bb as tntt

torch.set_num_threads(1)
P = tbb.P
EDGE = [0, 1, 2, P - 1, P - 2, (1 << 27), (1 << 27) + 1, (1 << 30) + 5,
        P // 2, P // 2 + 1]


def _canon(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _operands(seed, n=200):
    vals = np.concatenate([np.array(EDGE, dtype=np.uint64),
                           _canon(seed, n)])
    a, b = np.meshgrid(vals, vals[::-1][: len(vals) // 4])
    return a.ravel(), b.ravel()


def _mont(t):
    """The port's stored bit patterns as uint32."""
    return t.numpy().astype(np.uint32)


def _jref(fn, *canon):
    """The JAX function on the same canonical inputs, jitted; its stored
    Montgomery bit patterns as uint32."""
    out = jax.jit(fn)(*(jbb.from_ints(a) for a in canon))
    return np.asarray(out, dtype=np.uint32)


def _t(x):
    return tbb.from_ints(x)


def test_bb_representation_matches_jax():
    a = _canon(0, 64)
    np.testing.assert_array_equal(_mont(_t(a)),
                                  np.asarray(jbb.from_ints(a)))
    np.testing.assert_array_equal(tbb.to_ints(_t(a)), a)
    assert _mont(tbb.ones((1,)))[0] == int(jbb.MONT_ONE)
    assert _mont(tbb.full((1,), 12345))[0] == int(jbb.full((), 12345))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_bb_binary_ops_match_jax(op):
    a, b = _operands(1)
    np.testing.assert_array_equal(_mont(getattr(tbb, op)(_t(a), _t(b))),
                                  _jref(getattr(jbb, op), a, b))


def test_bb_unary_ops_match_jax():
    a, _ = _operands(2, n=64)
    np.testing.assert_array_equal(_mont(tbb.neg(_t(a))), _jref(jbb.neg, a))
    np.testing.assert_array_equal(_mont(tbb.inv(_t(a))), _jref(jbb.inv, a))
    np.testing.assert_array_equal(
        _mont(tbb.pow_const(_t(a), 7)),
        _jref(lambda x: jbb.pow_const(x, 7), a))
    np.testing.assert_array_equal(
        _mont(tbb.mul_const(_t(a), P - 5)),
        _jref(lambda x: jbb.mul_const(x, P - 5), a))


def test_bb_reductions_match_jax():
    x = _canon(3, (5, 37))
    x[0, :3] = [P - 1, P - 1, P - 2]
    for axis in (0, 1):
        for name in ("batch_prod", "cumprod", "batch_sum"):
            np.testing.assert_array_equal(
                _mont(getattr(tbb, name)(_t(x), axis=axis)),
                _jref(lambda a: getattr(jbb, name)(a, axis=axis), x))


def test_bb_grind_helpers_match_jax():
    cands = np.arange(0, 1 << 20, 4099, dtype=np.uint64)
    state = _canon(4, (len(cands), 16))
    got = tbb.grind_set_lane(_t(state), 8, torch.from_numpy(
        cands.astype(np.int64)))
    ref = jbb.grind_set_lane(jbb.from_ints(state), 8,
                             jax.numpy.asarray(cands.astype(np.uint32)))
    np.testing.assert_array_equal(_mont(got), np.asarray(ref))
    resp = np.array([0, (1 << 15) - 1, 1 << 15, P - 1], dtype=np.uint64)
    assert tbb.grind_response_ok(_t(resp), 15).tolist() == \
        np.asarray(jbb.grind_response_ok(jbb.from_ints(resp), 15)).tolist() \
        == [True, True, False, False]


@pytest.mark.parametrize("op", ["add", "sub", "mul", "inv", "frobenius"])
def test_bb4_ops_match_jax(op):
    a = [_canon(10 + d, 128) for d in range(4)]
    b = [_canon(20 + d, 128) for d in range(4)]
    a[0][:2] = 0            # one zero coefficient mixed into the batch

    def jfn(*xs):
        xa, xb = tuple(xs[:4]), tuple(xs[4:])
        if op in ("inv", "frobenius"):
            return getattr(jext.bb4, op)(xa)
        return getattr(jext.bb4, op)(xa, xb)

    ref = jax.jit(jfn)(*(jbb.from_ints(c) for c in a + b))
    ta, tb = tuple(_t(c) for c in a), tuple(_t(c) for c in b)
    got = (getattr(text.bb4, op)(ta) if op in ("inv", "frobenius")
           else getattr(text.bb4, op)(ta, tb))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_mont(g), np.asarray(r))


@pytest.mark.parametrize("n_log", [1, 3, 7, 10])
def test_bb_fft_ifft_match_jax(n_log):
    x = _canon(30 + n_log, (3, 1 << n_log))
    np.testing.assert_array_equal(
        _mont(tfft.fft(_t(x), F=tbb)), _jref(lambda a: jfft.fft(jbb, a), x))
    np.testing.assert_array_equal(
        _mont(tfft.ifft(_t(x), tbb)), _jref(lambda a: jfft.ifft(jbb, a), x))


@pytest.mark.parametrize("n_log,rate_bits", [(1, 1), (4, 3), (9, 3)])
def test_bb_lde_coset_fft_matches_jax(n_log, rate_bits):
    c = _canon(40 + n_log, (2, 1 << n_log))
    np.testing.assert_array_equal(
        _mont(tfft.lde_coset_fft(_t(c), rate_bits, tbb)),
        _jref(lambda a: jfft.lde_coset_fft(jbb, a, rate_bits), c))


def test_bb_coset_transforms_match_jax():
    x = _canon(50, (2, 64))
    np.testing.assert_array_equal(
        _mont(tfft.coset_fft(_t(x), 31, tbb)),
        _jref(lambda a: jfft.coset_fft(jbb, a, 31), x))
    np.testing.assert_array_equal(
        _mont(tfft.coset_ifft(_t(x), 31, tbb)),
        _jref(lambda a: jfft.coset_ifft(jbb, a, 31), x))


@pytest.mark.parametrize("n_log,r", [(8, 0), (10, 3)])
def test_bb_plain_ntt_matches_pallas_interpret(n_log, r):
    import plonky2_goldibear_tpu.ops.ntt_bb as JNTT
    import plonky2_goldibear_tpu.ops.poseidon_gl as JK

    x = _canon(60 + n_log, (2, 1 << n_log))
    x[:, (1 << n_log) >> r:] = 0
    old = JK._INTERPRET
    JK._INTERPRET = True
    try:
        ref = np.asarray(JNTT.fft(jbb.from_ints(x), zero_prefix_log=r))
    finally:
        JK._INTERPRET = old
    np.testing.assert_array_equal(_mont(tntt.fft_plain(_t(x), r)), ref)
    np.testing.assert_array_equal(_mont(tntt.fft(_t(x), r)), ref)


@pytest.fixture(scope="module")
def bb_lde_2e14():
    """A 2^14 LDE input (only the first 2^11 coefficients nonzero) and its
    JAX jnp NTT."""
    x = _canon(70, (1, 1 << 14))
    x[:, 1 << 11:] = 0
    return x, _jref(lambda a: jfft._fft_jnp(jbb, a), x)


@pytest.mark.parametrize("tile_log,r", [(13, 0), (13, 3), (5, 3)])
def test_bb_kernel_pass_split_matches_jnp_at_2e14(bb_lde_2e14, tile_log, r):
    """The BabyBear kernel's pass schedule (tiles of 2^13, or smaller to
    force more passes) against the JAX jnp NTT at 2^14."""
    x, ref = bb_lde_2e14
    np.testing.assert_array_equal(
        _mont(tntt.fft_by_passes(_t(x), r, tile_log)), ref)


def test_bb_fft_wrapper_refuses_bad_input():
    with pytest.raises(TypeError):
        tntt.fft(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        tntt.fft(tbb.zeros((3, 6)))
