"""The port's CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q

(``--noconftest``: ``tests/conftest.py`` imports jax, which a machine set
up for the port need not have.)  Without a card every test here skips.  Tolerance zero: exact field
arithmetic, except the f32 FMA probe chain (relative 1e-5: the kernel
rounds once with ``fmaf``, the plain version rounds a float64 sum).
"""

import numpy as np
import pytest
import torch

from plonky2_goldibear_torch import probes as runner
from plonky2_goldibear_torch.field import bb, gl
from plonky2_goldibear_torch.ops import keccak as KK
from plonky2_goldibear_torch.ops import ntt, ntt_bb
from plonky2_goldibear_torch.ops import probes as KP
from plonky2_goldibear_torch.ops import poseidon2_bb as K2
from plonky2_goldibear_torch.ops import poseidon_gl as K
from plonky2_goldibear_torch.ops import transcript as T

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _rand(device, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return gl.from_ints(rng.integers(0, gl.P, size=shape, dtype=np.uint64),
                        device)


@pytest.mark.parametrize("batch,n_log,r", [(3, 1, 0), (5, 8, 2), (4, 12, 0),
                                           (2, 15, 3), (1, 25, 0)])
def test_ntt_kernel(cuda, batch, n_log, r):
    x = _rand(cuda, batch, 1 << n_log, seed=n_log)
    x[:, (1 << n_log) >> r:] = 0
    assert torch.equal(ntt.fft(x, r), ntt.fft_plain(x, r))


@pytest.mark.parametrize("n", [1, 7, 1000, 1 << 17])
def test_permute_kernel(cuda, n):
    s = _rand(cuda, n, 12, seed=n)
    assert torch.equal(K.permute(s), K.permute_plain(s))


@pytest.mark.parametrize("n,length", [(5, 1), (33, 8), (100, 135), (64, 32)])
def test_leaf_sponge_kernel(cuda, n, length):
    s = _rand(cuda, n, length, seed=length)
    assert torch.equal(K.hash_leaves(s), K.hash_leaves_plain(s))


@pytest.mark.parametrize("n,layers", [(16, 4), (1024, 6), (1 << 15, 11)])
def test_merkle_levels_kernel(cuda, n, layers):
    d = _rand(cuda, n, 4, seed=n)
    got, ref = K.merkle_levels(d, layers), K.merkle_levels_plain(d, layers)
    assert len(got) == len(ref) == layers
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("n,layers", [(1 << 15, 15), (1 << 11, 7), (1 << 7, 3),
                                      (1 << 6, 2)])
def test_merkle_levels_plans(cuda, n, layers):
    """One subtree to the root, the FRI trees to a cap of 16, a tree that is
    all tail."""
    d = _rand(cuda, n, 4, seed=n + layers)
    got, ref = K.merkle_levels(d, layers), K.merkle_levels_plain(d, layers)
    assert len(got) == len(ref) == layers
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("group", K.GROUPS)
@pytest.mark.parametrize("parents", [1, 5, 300])
def test_merkle_level_each_group(cuda, group, parents):
    """One level launch of any width (the wrapper takes 2^k digests only),
    at each group size."""
    from plonky2_goldibear_torch.ops import _build

    d = _rand(cuda, 2 * parents, 4, seed=parents)
    out = torch.empty((parents, 4), dtype=torch.int64, device=cuda)
    err = K._lib(cuda).poseidon_gl_merkle_level(
        d.data_ptr(), out.data_ptr(), parents, group,
        K.block_for(parents * K.SPAN[group], 132), _build.stream_ptr(cuda))
    _build.check(err, "poseidon_gl_merkle_level")
    assert torch.equal(out, K._two_to_one_level_plain(d))


@pytest.mark.parametrize("layers", range(1, K.TAIL_MAX_LAYERS + 1))
@pytest.mark.parametrize("cap", [1, 16])
def test_merkle_tail_each_depth(cuda, layers, cap):
    width = cap << layers
    d = _rand(cuda, width, 4, seed=width)
    got = K._levels(d, [("tail", width, layers, cap, 16 << (layers - 1))])
    ref = K.merkle_levels_plain(d, layers)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("length", [1, 7, 8, 9, 16, 20, 32, 135])
def test_leaf_sponge_lengths(cuda, length):
    n = 1000 + length                   # not a multiple of any block
    s = _rand(cuda, n, length, seed=length)
    assert torch.equal(K.hash_leaves(s), K.hash_leaves_plain(s))


@pytest.mark.parametrize("group", K.GROUPS)
@pytest.mark.parametrize("n,length,num_out", [(77, 9, 4), (300, 135, 4),
                                              (33, 16, 12)])
def test_leaf_sponge_each_group(cuda, group, n, length, num_out):
    s = _rand(cuda, n, length, seed=n)
    assert torch.equal(K._sponge(s, num_out, group),
                       K.hash_leaves_plain(s, num_out))


# -- BabyBear (Montgomery-form int32 tensors) --------------------------------


def _rand_bb(device, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return bb.from_ints(rng.integers(0, bb.P, size=shape, dtype=np.uint64),
                        device)


@pytest.mark.parametrize("batch,n_log,r", [(3, 1, 0), (5, 8, 2), (4, 12, 0),
                                           (3, 13, 0), (2, 15, 3),
                                           (1, 25, 0)])
def test_ntt_bb_kernel(cuda, batch, n_log, r):
    x = _rand_bb(cuda, batch, 1 << n_log, seed=n_log)
    x[:, (1 << n_log) >> r:] = 0
    assert torch.equal(ntt_bb.fft(x, r), ntt_bb.fft_plain(x, r))


# every cluster size at each NTT shape of a BabyBear 2^12 prove, and the
# single rows the prover sent before batching
_BB_NTT_SHAPES = [(167, 12, 0), (167, 15, 3), (36, 12, 0), (36, 15, 3),
                  (6, 15, 0), (48, 15, 3), (4, 15, 0), (4, 12, 0), (4, 9, 0),
                  (4, 6, 0), (1, 15, 0), (1, 12, 0)]


@pytest.mark.parametrize("batch,n_log,r,c_log", [
    (b, n, r, c) for b, n, r in _BB_NTT_SHAPES
    for c in ntt_bb.cluster_logs(n, r)])
def test_ntt_bb_each_cluster_size(cuda, batch, n_log, r, c_log):
    x = _rand_bb(cuda, batch, 1 << n_log, seed=n_log + c_log)
    x[:, (1 << n_log) >> r:] = 0
    p = ntt_bb.cluster_plan(batch, n_log, c_log, 132, r)
    got, launched = ntt_bb._launch(x, r, p)
    assert launched == 1
    assert torch.equal(got, ntt_bb.fft_plain(x, r))


@pytest.mark.parametrize("batch,n_log,r", _BB_NTT_SHAPES + [
    (2, 16, 0), (1, 17, 3), (3, 5, 2), (2, 2, 0)])
def test_ntt_bb_plan(cuda, batch, n_log, r):
    """The launch ``plan`` picks (one cluster launch up to 2^15; the bit-
    reversal and the passes above)."""
    x = _rand_bb(cuda, batch, 1 << n_log, seed=batch + n_log)
    x[:, (1 << n_log) >> r:] = 0
    ntt_bb.reset_launches()
    got = ntt_bb.fft(x, r)
    assert ntt_bb.launches == (1 if n_log <= ntt_bb.CLUSTER_MAX_LOG else
                               1 + len(ntt.pass_plan(n_log, 13)))
    assert torch.equal(got, ntt_bb.fft_plain(x, r))


# every cluster size at each NTT shape of a Goldilocks 2^12 prove
_GL_NTT_SHAPES = [(135, 12, 0), (135, 15, 3), (20, 12, 0), (20, 15, 3),
                  (2, 15, 0), (16, 15, 3), (2, 11, 0), (2, 7, 0), (1, 15, 0)]


@pytest.mark.parametrize("batch,n_log,r,c_log", [
    (b, n, r, c) for b, n, r in _GL_NTT_SHAPES
    for c in ntt_bb.cluster_logs(n, r, gl)])
def test_ntt_gl_each_cluster_size(cuda, batch, n_log, r, c_log):
    x = _rand(cuda, batch, 1 << n_log, seed=n_log + c_log)
    x[:, (1 << n_log) >> r:] = 0
    x[0, :(1 << n_log) >> r] = gl.from_ints([gl.P - 1], cuda)
    p = ntt_bb.cluster_plan(batch, n_log, c_log, 132, r, gl)
    got, launched = ntt_bb._launch(x, r, p, gl)
    assert launched == 1
    assert torch.equal(got, ntt.fft_plain(x, r))


@pytest.mark.parametrize("batch,n_log,r", _GL_NTT_SHAPES + [
    (2, 16, 0), (1, 17, 3), (3, 5, 2), (2, 2, 0)])
def test_ntt_gl_plan(cuda, batch, n_log, r):
    """The launch ``plan`` picks for Goldilocks (one cluster launch up to
    2^15; the bit-reversal and the passes of 2^12 above)."""
    x = _rand(cuda, batch, 1 << n_log, seed=batch + n_log)
    x[:, (1 << n_log) >> r:] = 0
    ntt.reset_launches()
    got = ntt.fft(x, r)
    assert ntt.launches == (1 if n_log <= ntt_bb.CLUSTER_MAX_LOG else
                            1 + len(ntt.pass_plan(n_log, ntt.LOG_TILE)))
    assert torch.equal(got, ntt.fft_plain(x, r))


@pytest.mark.parametrize("n", [1, 7, 1000, 1 << 17])
def test_poseidon2_bb_permute_kernel(cuda, n):
    s = _rand_bb(cuda, n, 16, seed=n)
    assert torch.equal(K2.permute(s), K2.permute_plain(s))


@pytest.mark.parametrize("n,length", [(5, 1), (33, 8), (100, 167),
                                      (64, 32), (9, 45)])
def test_poseidon2_bb_leaf_sponge_kernel(cuda, n, length):
    s = _rand_bb(cuda, n, length, seed=length)
    assert torch.equal(K2.hash_leaves(s), K2.hash_leaves_plain(s))


@pytest.mark.parametrize("group", K2.SPONGE_GROUPS)
@pytest.mark.parametrize("n,length,num_out", [
    (1 << 15, 167, 8), (1 << 15, 36, 8), (1 << 15, 48, 8), (1 << 12, 32, 8),
    (1 << 9, 32, 8), (1 << 6, 32, 8), (77, 9, 16), (5, 1, 3)])
def test_poseidon2_bb_leaf_sponge_each_group(cuda, group, n, length,
                                             num_out):
    """Every group size at each sponge shape of a BabyBear 2^12 prove and
    at ragged ones; rows of all p - 1 among them."""
    s = _rand_bb(cuda, n, length, seed=length + group)
    s[-1] = bb.from_ints([bb.P - 1], cuda)
    got = K2._sponge(s, num_out, group, K2.block_for(n * group, 132))
    assert torch.equal(got, K2.hash_leaves_plain(s, num_out))


@pytest.mark.parametrize("n,layers", [(16, 4), (1024, 6), (1 << 15, 11)])
def test_poseidon2_bb_merkle_levels_kernel(cuda, n, layers):
    d = _rand_bb(cuda, n, 8, seed=n)
    got, ref = K2.merkle_levels(d, layers), K2.merkle_levels_plain(d, layers)
    assert len(got) == len(ref) == layers
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("n,layers", [(1 << 15, 15), (1 << 12, 8),
                                      (1 << 9, 5), (1 << 6, 2), (1 << 17, 12)])
def test_poseidon2_bb_merkle_levels_plans(cuda, n, layers):
    """One subtree to the root, the FRI trees of a BB prove to a cap of
    16."""
    d = _rand_bb(cuda, n, 8, seed=n + layers)
    got, ref = K2.merkle_levels(d, layers), K2.merkle_levels_plain(d, layers)
    assert len(got) == len(ref) == layers
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("group", K2.GROUPS)
@pytest.mark.parametrize("parents", [1, 5, 300, 4096])
def test_poseidon2_bb_merkle_level_each_group(cuda, group, parents):
    """One level launch of any width at each group size."""
    d = _rand_bb(cuda, 2 * parents, 8, seed=parents)
    got = K2._levels(d, [("level", parents, group,
                          K2.block_for(parents * group, 132))])
    assert torch.equal(got[0], K2.merkle_levels_plain(d, 1)[0])


@pytest.mark.parametrize("layers", range(1, K2.SUBTREE_MAX_LAYERS + 1))
@pytest.mark.parametrize("subtrees", [1, 16, 256])
def test_poseidon2_bb_merkle_subtree_each_depth(cuda, layers, subtrees):
    """One subtree launch: a tree's top (one block per cap node) or a band
    of narrow levels below it (256 subtrees)."""
    width = subtrees << layers
    d = _rand_bb(cuda, width, 8, seed=width + layers)
    got = K2._levels(d, [("subtree", width, layers, subtrees,
                          K2.SUBTREE_GROUP << (layers - 1))])
    ref = K2.merkle_levels_plain(d, layers)
    assert len(got) == layers
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


# -- the probe chains ----------------------------------------------------------


@pytest.mark.parametrize("n", [1000, 1 << 16])
@pytest.mark.parametrize("step", list(KP.STEPS))
def test_probe_chain_kernel(cuda, step, n):
    x = runner.make_input(step, n, cuda, seed=n)
    reps = KP.unroll(step) + 5      # one pass of the main loop, a remainder
    got, ref = KP.chain(x, step, reps), KP.chain_plain(x, step, reps)
    if step == "f32_fma":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, ref)


# -- Keccak ----------------------------------------------------------------


def _bytes(device, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=shape,
                                         dtype=np.uint8)).to(device)


@pytest.mark.parametrize("length", [0, 1, 25, 50, 96, 135, 136, 137, 271,
                                    272, 680, 1080])
@pytest.mark.parametrize("n", [1, 129, 5000])
def test_keccak_rows_kernel(cuda, n, length):
    rows = _bytes(cuda, n, length, seed=length)
    assert torch.equal(KK.hash_rows(rows), KK.hash_rows_plain(rows))
    # contiguous rows that start off an 8-byte boundary: the byte loads
    odd = _bytes(cuda, n * length + 1, seed=length + 1)[1:].view(n, length)
    assert torch.equal(KK.hash_rows(odd), KK.hash_rows_plain(odd))


@pytest.mark.parametrize("n,layers", [(2, 1), (16, 4), (1 << 15, 11),
                                      (1 << 17, 13), (64, 0)])
def test_keccak_merkle_levels_kernel(cuda, n, layers):
    d0 = _bytes(cuda, n, 25, seed=n)
    got, ref = KK.merkle_levels(d0, layers), KK.merkle_levels_plain(d0,
                                                                     layers)
    assert len(got) == len(ref) == layers
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("n", [1, 1000, 1 << 17])
def test_keccak_permute_kernel(cuda, n):
    s = _rand(cuda, n, 12, seed=n)
    assert torch.equal(KK.permute(s), KK.permute_plain(s))


# -- Keccak launch geometry: every group size, subtree depth and plan --------

KECCAK_PROVE_LENGTHS = (128, 160, 256, 672, 680, 1080)


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.parametrize("length", KECCAK_PROVE_LENGTHS + (7, 135, 137))
@pytest.mark.parametrize("group", KK.GROUPS)
@pytest.mark.parametrize("n", [1, 129, 1 << 11])
def test_keccak_rows_group_kernel(cuda, n, group, length):
    rows = _bytes(cuda, n, length, seed=n + length)
    ref = KK.hash_rows_plain(rows)
    threads = KK.block_for(KK.threads_for(n, group), _sms(cuda))
    assert torch.equal(KK._rows(rows, 25, group, threads), ref)
    for threads in (32, KK.MAX_THREADS):
        assert torch.equal(KK._rows(rows, 25, group, threads), ref)


@pytest.mark.parametrize("length", KECCAK_PROVE_LENGTHS)
@pytest.mark.parametrize("n", [1 << 7, 1 << 11, 1 << 15])
def test_keccak_rows_prove_lengths(cuda, n, length):
    rows = _bytes(cuda, n, length, seed=length)
    assert torch.equal(KK.hash_rows(rows), KK.hash_rows_plain(rows))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("group", KK.GROUPS)
@pytest.mark.parametrize("parents", [1, 13, 1 << 14])
def test_keccak_level_group_kernel(cuda, parents, group, offset):
    raw = _bytes(cuda, 2 * parents * 25 + offset, seed=parents + offset)
    d0 = raw[offset:].view(2 * parents, 25)
    ref = KK.merkle_levels_plain(d0, 1)[0]
    plan = (("level", parents, group,
             KK.block_for(KK.threads_for(parents, group), _sms(cuda))),)
    assert torch.equal(KK._levels(d0, plan)[0], ref)


@pytest.mark.parametrize("subtrees", [1, 16, 300])
@pytest.mark.parametrize("layers", range(1, KK.TAIL_LAYERS + 1))
def test_keccak_subtree_kernel(cuda, layers, subtrees):
    width = subtrees << layers
    d0 = _bytes(cuda, width, 25, seed=width)
    ref = KK.merkle_levels_plain(d0, layers)
    got = KK._levels(d0, (("subtree", width, layers),))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("cap", [1, 16])
@pytest.mark.parametrize("bits", range(1, 18))
def test_keccak_merkle_plan_trees(cuda, bits, cap):
    n = 1 << bits
    layers = max(bits - (cap.bit_length() - 1), 0)
    d0 = _bytes(cuda, n, 25, seed=bits)
    got = KK.merkle_levels(d0, layers)
    ref = KK.merkle_levels_plain(d0, layers)
    assert len(got) == len(ref) == layers
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


# -- the device transcript's kernels (csrc/transcript.cu) -------------------

TRANSCRIPT = {"gl": (gl, 12), "bb": (bb, 16)}


def _field_rand(F, device, n, seed):
    rng = np.random.default_rng(seed)
    return F.from_ints(rng.integers(0, F.P, size=n, dtype=np.uint64), device)


# (pending lengths, outputs left, challenges): full chunks and a partial
# one; a last observe that refills the outputs, squeezed from and past;
# squeezes with nothing absorbed, within the buffer, past it and from an
# empty one; a pure absorb with a leftover and with none; more pieces than
# the pointer table holds; a long absorb
FLUSH_CASES = [((3, 10), 0, 5), ((8,), 0, 2), ((16,), 0, 11), ((), 5, 3),
               ((), 2, 7), ((), 0, 1), ((16, 3), 0, 0), ((24,), 0, 0),
               ((1,) * 11, 0, 4), ((400, 3), 0, 4)]


@pytest.mark.parametrize("case", FLUSH_CASES, ids=str)
@pytest.mark.parametrize("field", list(TRANSCRIPT))
def test_transcript_flush_kernel(cuda, field, case):
    F, W = TRANSCRIPT[field]
    lens, n_out, n = case
    state = _field_rand(F, cuda, W, 1)
    out_buf = _field_rand(F, cuda, T.RATE, 2)
    pieces = [_field_rand(F, cuda, k, 3 + i) for i, k in enumerate(lens)]
    before = T.launches["transcript_flush"]
    got = T.transcript_flush(state, out_buf, pieces, n_out, n)
    assert T.launches["transcript_flush"] == before + 1
    assert torch.equal(got, T.transcript_flush_plain(state, out_buf, pieces,
                                                     n_out, n))


# (PoW bits, leftover L, where the witness lies): in the first chunk, in a
# later block of the first wave of claims, past the first wave (a later
# claim), or anywhere
GRIND_CASES = [(2, 0, "first chunk"), (14, 7, "later block"),
               (24, 3, "later claim"), (6, 3, None), (16, 1, None),
               (20, 5, None)]


@pytest.mark.parametrize("pow_bits,L,where", GRIND_CASES, ids=str)
@pytest.mark.parametrize("field", list(TRANSCRIPT))
def test_pow_grind_kernel(cuda, field, pow_bits, L, where):
    F, W = TRANSCRIPT[field]
    state = _field_rand(F, cuda, W, pow_bits)
    left = _field_rand(F, cuda, L, L + 9) if L else None
    k = F.SPEC.bits - pow_bits
    out, scratch = T.pow_grind(state, left, k)
    assert torch.equal(out, T.pow_grind_plain(state, left, k))
    w, found = (int(v) for v in F.to_ints(out))
    chunk = T.GRIND_CHUNK
    wave = chunk * T.GRIND_BLOCKS_PER_SM * K._sms(cuda)
    assert found == 1
    assert int(scratch[3]) * chunk > w      # every chunk up to w tested
    if where is not None:
        assert where == ("first chunk" if w < chunk else
                         "later block" if w < wave else "later claim")


def test_pow_grind_kernel_exhausts_without_a_hang(cuda):
    """Goldilocks at k = 0 (a response of 0, which no candidate below 2^32
    gives but with odds of 2^-32): the search stops with the flag at 0
    after testing every candidate."""
    F, W = TRANSCRIPT["gl"]
    out, scratch = T.pow_grind(_field_rand(F, cuda, W, 5), None, 0)
    assert F.to_ints(out).tolist() == [0, 0]
    assert int(scratch[3]) * T.GRIND_CHUNK == 1 << 32
