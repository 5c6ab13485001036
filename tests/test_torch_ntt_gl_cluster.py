"""The Goldilocks cluster NTT (``csrc/ntt_gl.cu`` instantiating
``csrc/ntt_cluster.cuh``; ``ops/ntt_bb.py``'s plan and replay with
``F = gl``, launched by ``ops/ntt.py:fft``) on the CPU.

- ``fft_by_cluster(x, r, c_log, F=gl)`` replays the kernel's schedule at
  every cluster size the kernel takes at the row's length; it equals
  ``fft_plain`` and the JAX package's ``ops/ntt.py`` NTT in interpret
  mode.
- The device code, compiled by the host C++ compiler against the stub
  runtime of ``test_torch_ntt_bb_cluster.py`` (a cluster's blocks as
  threads), equals ``fft_plain``, and so do the bit-reversal and pass
  kernels of rows above 2^15; it skips where no ``g++`` is found.
- ``plan`` gives every NTT call of a Goldilocks 2^12 prove one launch
  that spreads over the card within u64 shared memory, and the source's
  limits equal the wrapper's.

Sizes stay at or under 2^10 (2^14 for the passes' host run).  Tolerance
zero throughout: exact field arithmetic.
"""

import subprocess
from functools import lru_cache

import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.field import gl as jgl

from plonky2_goldibear_torch.field import gl as tgl
from plonky2_goldibear_torch.ops import _build
from plonky2_goldibear_torch.ops import ntt as tntt
from plonky2_goldibear_torch.ops import ntt_bb as K

from test_torch_ntt_bb_cluster import HOST_CASES, _int, build_harness

torch.set_num_threads(1)
P = tgl.P
SOURCE = _build.CSRC + "/ntt_gl.cu"
H100_SMS = 132
BATCH = 6


def _rows(seed, batch, n_log, r):
    x = np.random.default_rng(seed).integers(0, P, size=(batch, 1 << n_log),
                                             dtype=np.uint64)
    x[:, (1 << n_log) >> r:] = 0
    return x


@lru_cache(maxsize=None)
def _jax_case(n_log, r):
    """BATCH seeded rows (some of P - 1) and the JAX NTT of them in
    interpret mode."""
    import plonky2_goldibear_tpu.ops.ntt as JNTT
    import plonky2_goldibear_tpu.ops.poseidon_gl as JK

    x = _rows(90 + n_log + r, BATCH, n_log, r)
    x[0, :(1 << n_log) >> r] = P - 1
    old = JK._INTERPRET
    JK._INTERPRET = True
    try:
        ref = jgl.to_ints(JNTT.fft(jgl.from_ints(x), zero_prefix_log=r))
    finally:
        JK._INTERPRET = old
    return x, ref


@pytest.mark.parametrize("batch", [1, 4, 6])
@pytest.mark.parametrize("n_log,r", [(8, 0), (8, 3), (10, 0), (10, 3)])
def test_gl_cluster_schedule_matches_plain_and_pallas(n_log, r, batch):
    x, ref = _jax_case(n_log, r)
    x, ref = x[:batch], ref[:batch]
    t = tgl.from_ints(x)
    np.testing.assert_array_equal(tgl.to_ints(tntt.fft_plain(t, r)), ref)
    for c_log in [c for c in range(K.MAX_CLUSTER_LOG + 1) if c == 0 or (
            n_log - c > r and n_log - 2 * c >= 2)]:
        np.testing.assert_array_equal(
            tgl.to_ints(K.fft_by_cluster(t, r, c_log, tgl)), ref,
            err_msg=f"c_log {c_log}")


# -- the device code on the host ------------------------------------------


@pytest.fixture(scope="module")
def gl_host_binary(tmp_path_factory):
    """The harness built from ``csrc/ntt_gl.cu`` as it is."""
    return build_harness(tmp_path_factory.mktemp("ntt_gl_host"), "ntt_gl",
                         "GL")


def _run(binary, args, x, n_log):
    tw = tntt.twiddles(n_log, "cpu", tgl)
    text = " ".join(map(str, tgl.to_ints(tw))) + "\n" + \
        " ".join(map(str, tgl.to_ints(x).ravel()))
    out = subprocess.run([binary] + [str(a) for a in args], input=text,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    return np.array(out.split(), dtype=np.uint64).reshape(x.shape)


@pytest.mark.parametrize("n_log,r,c_log,batch,clusters,threads", HOST_CASES)
def test_gl_device_ntt_on_host(gl_host_binary, n_log, r, c_log, batch,
                               clusters, threads):
    x = _rows(n_log * 10 + c_log, batch, n_log, r)
    x[-1, :(1 << n_log) >> r] = P - 1
    x = tgl.from_ints(x)
    got = _run(gl_host_binary, (n_log, c_log, r, batch, clusters, threads),
               x, n_log)
    np.testing.assert_array_equal(got, tgl.to_ints(tntt.fft_plain(x, r)))


@pytest.mark.parametrize("n_log,r,batch", [(14, 0, 2), (14, 3, 1),
                                           (12, 2, 3)])
def test_gl_device_passes_on_host(gl_host_binary, n_log, r, batch):
    """Rows above 2^15 take the bit-reversal launch and then the passes of
    ntt.cuh (tiles of 2^12: two passes at 2^14)."""
    x = tgl.from_ints(_rows(n_log + r, batch, n_log, r))
    got = _run(gl_host_binary, ("passes", n_log, r, batch), x, n_log)
    np.testing.assert_array_equal(got, tgl.to_ints(tntt.fft_plain(x, r)))


# -- the launch plan -------------------------------------------------------


def test_gl_cuda_source_limits():
    assert _int("LOG_TILE", SOURCE) == tntt.LOG_TILE
    assert _int("CLUSTER_MAX_LOG", SOURCE) == K.CLUSTER_MAX_LOG
    assert _int("MAX_CLUSTER_LOG", SOURCE) == K.MAX_CLUSTER_LOG
    assert _int("MAX_THREADS", SOURCE) == K.MAX_THREADS
    assert _int("MAX_SMEM", SOURCE) == K.MAX_SMEM
    assert _int("MAX_XCHG", SOURCE) == K.MAX_XCHG
    assert _int("MAX_R", SOURCE) == K.MAX_R


# every NTT call of a 2^12 Goldilocks prove (135 wires, 2 challenges, gl2
# FRI of arity 2^4): wires, Z and partial products, the quotient's coset
# iFFT and LDE, the FRI polynomials
GL_PROVE_CALLS = [(135, 12, 0), (135, 15, 3), (20, 12, 0), (20, 15, 3),
                  (2, 15, 0), (16, 15, 3), (2, 15, 0), (2, 11, 0),
                  (2, 7, 0)]


@pytest.mark.parametrize("batch,n_log,r", GL_PROVE_CALLS)
def test_gl_plan_is_one_launch_that_spreads(batch, n_log, r):
    p = K.plan(batch, n_log, H100_SMS, r, tgl)
    logs = K.cluster_logs(n_log, r, tgl)
    assert p.route == "cluster"
    assert p.c_log in logs
    assert p.smem == K.smem_bytes(n_log, p.c_log, r, tgl) <= K.MAX_SMEM
    assert p.smem == 8 * ((3 << (n_log - p.c_log))
                          + ((1 << (n_log - p.c_log)) >> r)
                          - (1 << (n_log - 2 * p.c_log)))
    assert p.threads % 32 == 0 and 32 <= p.threads <= K.MAX_THREADS
    assert 1 <= p.clusters <= batch
    # the exchange fits a thread's 16-byte registers
    assert p.c_log == 0 or 8 << (n_log - p.c_log) <= \
        16 * K.MAX_XCHG * p.threads
    blocks = p.clusters << p.c_log
    assert blocks >= min(H100_SMS, batch << logs[-1])


def test_gl_plan_routes():
    assert K.plan(1, 25, H100_SMS, 0, tgl).route == "passes"
    assert K.plan(1, 16, H100_SMS, 0, tgl).route == "passes"
    # a 2^15 row of u64 needs a cluster of 8 or 16 blocks
    assert K.cluster_logs(15, 3, tgl) == [3, 4]
    assert K.cluster_logs(15, 0, tgl) == [3, 4]
    assert K.cluster_logs(6, 0, tgl) == [0]
    p = K.plan(135, 15, H100_SMS, 3, tgl)
    assert p.c_log == 3 and p.smem == 98304
    assert K.blocks_per_sm(15, 3, 3, tgl) * p.threads >= K.FILL_THREADS


def test_gl_fft_refuses_a_zero_prefix_beyond_the_row():
    with pytest.raises(ValueError):
        tntt.fft(tgl.zeros((2, 8)), 4)
