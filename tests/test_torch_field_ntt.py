"""The port's Goldilocks field and NTT against the JAX package, bit for bit.

Inputs are made with numpy from a seed and handed to both sides; the
tolerance is zero (exact integer field arithmetic).  The JAX NTT kernel
runs in interpret mode, as tests/test_ops_kernels.py runs it.
"""

import os

import jax
import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.field import fft as jfft
from plonky2_goldibear_tpu.field import gl as jgl

from plonky2_goldibear_torch.field import fft as tfft
from plonky2_goldibear_torch.field import gl as tgl
from plonky2_goldibear_torch.ops import ntt as tntt

torch.set_num_threads(1)
P = tgl.P
EDGE = [0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 1 << 63,
        (1 << 63) - 1, P - (1 << 32)]


def _operands(seed, n=200):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([np.array(EDGE, dtype=np.uint64),
                           rng.integers(0, P, size=n, dtype=np.uint64)])
    a, b = np.meshgrid(vals, vals[::-1][: len(vals) // 4])
    return a.ravel(), b.ravel()


def _t(x):
    return tgl.from_ints(x)


def _jref(fn, *arrays):
    """The JAX function on numpy inputs, jitted (one XLA compile instead
    of one per eager op), as numpy uint64."""
    out = jax.jit(fn)(*(jgl.from_ints(a) for a in arrays))
    return jgl.to_ints(out)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_gl_binary_ops_match_jax(op):
    a, b = _operands(1)
    out = tgl.to_ints(getattr(tgl, op)(_t(a), _t(b)))
    ref = _jref(getattr(jgl, op), a, b)
    np.testing.assert_array_equal(out, ref)


def test_gl_unary_ops_match_jax():
    a, _ = _operands(2, n=64)
    nz = a[a != 0]
    np.testing.assert_array_equal(tgl.to_ints(tgl.neg(_t(a))),
                                  _jref(jgl.neg, a))
    np.testing.assert_array_equal(tgl.to_ints(tgl.inv(_t(nz))),
                                  _jref(jgl.inv, nz))
    np.testing.assert_array_equal(tgl.to_ints(tgl.pow_const(_t(a), 7)),
                                  _jref(lambda x: jgl.pow_const(x, 7), a))
    np.testing.assert_array_equal(
        tgl.to_ints(tgl.mul_const(_t(a), P - 5)),
        _jref(lambda x: jgl.mul_const(x, P - 5), a))


def test_gl_reductions_match_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, P, size=(5, 37), dtype=np.uint64)
    x[0, :4] = [P - 1, P - 1, 1 << 63, (1 << 32) - 1]
    for axis in (0, 1):
        for name in ("batch_prod", "cumprod", "batch_sum"):
            np.testing.assert_array_equal(
                tgl.to_ints(getattr(tgl, name)(_t(x), axis=axis)),
                _jref(lambda a: getattr(jgl, name)(a, axis=axis), x))


def test_gl_grind_helpers():
    resp = _t(np.array([0, (1 << 48) - 1, 1 << 48, P - 1], dtype=np.uint64))
    assert tgl.grind_response_ok(resp, 48).tolist() == \
        [True, True, False, False]
    state = tgl.zeros((3, 12))
    out = tgl.grind_set_lane(state, 5, torch.tensor([7, 8, 9]))
    assert out[:, 5].tolist() == [7, 8, 9] and int(state.abs().sum()) == 0


@pytest.mark.parametrize("n_log", [1, 2, 3, 5, 7, 10])
def test_fft_ifft_match_jax(n_log):
    rng = np.random.default_rng(10 + n_log)
    x = rng.integers(0, P, size=(3, 1 << n_log), dtype=np.uint64)
    np.testing.assert_array_equal(tgl.to_ints(tfft.fft(_t(x))),
                                  _jref(lambda a: jfft.fft(jgl, a), x))
    np.testing.assert_array_equal(tgl.to_ints(tfft.ifft(_t(x))),
                                  _jref(lambda a: jfft.ifft(jgl, a), x))


@pytest.mark.parametrize("n_log,rate_bits", [(1, 1), (4, 3), (7, 2),
                                             (9, 1)])
def test_lde_coset_fft_matches_jax(n_log, rate_bits):
    rng = np.random.default_rng(20 + n_log)
    c = rng.integers(0, P, size=(2, 1 << n_log), dtype=np.uint64)
    np.testing.assert_array_equal(
        tgl.to_ints(tfft.lde_coset_fft(_t(c), rate_bits)),
        _jref(lambda a: jfft.lde_coset_fft(jgl, a, rate_bits), c))


def test_coset_transforms_match_jax():
    rng = np.random.default_rng(30)
    x = rng.integers(0, P, size=(2, 64), dtype=np.uint64)
    np.testing.assert_array_equal(
        tgl.to_ints(tfft.coset_fft(_t(x), 7)),
        _jref(lambda a: jfft.coset_fft(jgl, a, 7), x))
    np.testing.assert_array_equal(
        tgl.to_ints(tfft.coset_ifft(_t(x), 7)),
        _jref(lambda a: jfft.coset_ifft(jgl, a, 7), x))
    np.testing.assert_array_equal(
        tgl.to_ints(tfft.reverse_index_bits(_t(x), dim=-1)),
        _jref(lambda a: jfft.reverse_index_bits(a, axis=-1), x))


@pytest.mark.parametrize("n_log", [8, 9])
def test_plain_ntt_matches_pallas_interpret(n_log):
    import plonky2_goldibear_tpu.ops.ntt as JNTT
    import plonky2_goldibear_tpu.ops.poseidon_gl as JK

    rng = np.random.default_rng(40 + n_log)
    x = rng.integers(0, P, size=(2, 1 << n_log), dtype=np.uint64)
    xz = x.copy()
    xz[:, (1 << n_log) >> 2:] = 0
    old = JK._INTERPRET
    JK._INTERPRET = True
    try:
        ref = jgl.to_ints(JNTT.fft(jgl.from_ints(x)))
        ref_zp = jgl.to_ints(JNTT.fft(jgl.from_ints(xz), zero_prefix_log=2))
    finally:
        JK._INTERPRET = old
    np.testing.assert_array_equal(tgl.to_ints(tntt.fft_plain(_t(x))), ref)
    np.testing.assert_array_equal(tgl.to_ints(tntt.fft_plain(_t(xz), 2)),
                                  ref_zp)


@pytest.fixture(scope="module")
def lde_2e14():
    """A 2^14 LDE input (only the first 2^11 coefficients nonzero) and its
    JAX jnp NTT."""
    rng = np.random.default_rng(50)
    x = rng.integers(0, P, size=(1, 1 << 14), dtype=np.uint64)
    x[:, 1 << 11:] = 0
    return x, _jref(lambda a: jfft._fft_jnp(jgl, a), x)


@pytest.mark.parametrize("tile_log,r", [(7, 0), (12, 3), (5, 3), (4, 1)])
def test_kernel_pass_split_matches_jnp_at_2e14(lde_2e14, tile_log, r):
    """The kernel's multi-pass schedule (tiles of 2^tile_log, passes over
    (column, k) slices, zero-prefix stages skipped) against the JAX jnp NTT
    at 2^14."""
    x, ref = lde_2e14
    np.testing.assert_array_equal(
        tgl.to_ints(tntt.fft_by_passes(_t(x), r, tile_log)), ref)
    assert len(tntt.pass_plan(14, tile_log)) == -(-14 // tile_log)


def test_ntt_lazy_sub_regression():
    """The sigma column of the round-3 TPU prove failure (a lazy subtract
    that wrapped twice) must transform exactly."""
    z = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "ntt_lazy_sub_regression.npz"))
    x = z["xlo"].astype(np.uint64) | (z["xhi"].astype(np.uint64) << 32)
    o = z["olo"].astype(np.uint64) | (z["ohi"].astype(np.uint64) << 32)
    np.testing.assert_array_equal(tgl.to_ints(tntt.fft(_t(x[None])))[0], o)
    np.testing.assert_array_equal(
        tgl.to_ints(tntt.fft_by_passes(_t(x[None]), 0, 4))[0], o)


def test_fft_wrapper_refuses_bad_input():
    with pytest.raises(TypeError):
        tntt.fft(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        tntt.fft(tgl.zeros((3, 6)))
