"""The port's Keccak modules against the JAX package and the host Keccak,
on the CPU, exact (tolerance zero: bytes and field words compared with
equality).

- ``hash/keccak_device.py`` (the plain torch twin, which ``ops/keccak.py``
  runs on a CPU tensor): batched Keccak-256 against ``utils/keccak.py`` and
  the JAX ``keccak_device.keccak256_bytes`` at the lengths around the
  rate's edges (135, 136, 137, 271, 272) and at the prove's (25, 50, 96,
  1080); the hash-onion against the JAX ``keccak_hasher.permute_host``,
  also with words of p and above fed to the sampler (the hash's output
  changed on both sides in the same way).
- The CUDA source's device code, compiled by the host C++ compiler against
  a stub of the CUDA runtime (each launch a loop over the grid's threads):
  its three entry points against the twin and the JAX host functions, the
  rejection branch through the source's ``ONION_TEST_HOOK``; skipped
  without ``g++``.  The round constants written in the source equal
  ``utils/keccak.py``'s.
- ``hash/keccak_hasher.py``'s host functions, its device leaf hash (the
  noop pack up to 3 elements) and Merkle tree (cap, proofs, tampered leaves
  rejected) against the JAX ``keccak_hasher`` (mirroring the JAX package's
  ``tests/test_keccak_config.py:31-52``), and the challenger's byte
  digests against the JAX challenger.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from plonky2_goldibear_torch.field import gl, host  # noqa: E402
from plonky2_goldibear_torch.hash import keccak_device as kd  # noqa: E402
from plonky2_goldibear_torch.hash import keccak_hasher as KH  # noqa: E402
from plonky2_goldibear_torch.hash import merkle  # noqa: E402
from plonky2_goldibear_torch.hash.challenger import Challenger  # noqa: E402
from plonky2_goldibear_torch.ops import _build  # noqa: E402
from plonky2_goldibear_torch.ops import keccak as K  # noqa: E402
from plonky2_goldibear_torch.utils import keccak as ukeccak  # noqa: E402
from plonky2_goldibear_tpu.hash import keccak_device as jkd  # noqa: E402
from plonky2_goldibear_tpu.hash import keccak_hasher as JKH  # noqa: E402

torch.set_num_threads(1)
P = host.GOLDILOCKS.p
LENGTHS = (0, 1, 25, 50, 96, 135, 136, 137, 271, 272, 1080)
SOURCE = os.path.join(_build.CSRC, "keccak.cu")
# a word the sampler must reject: any with these bits set is >= p
REJECT = 0xFFFFFFFF00000001


def _msgs(length, n=5):
    rng = np.random.default_rng(length)
    return rng.integers(0, 256, size=(n, length), dtype=np.uint8)


def _states(n, seed=0):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, P, size=(n, 12), dtype=np.uint64)
    states[0] = P - 1
    states[1] = 0
    return states


def _ints(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint64)


# -- the twin ---------------------------------------------------------------


@pytest.mark.parametrize("length", LENGTHS)
def test_keccak256_twin_matches_host_and_jax(length):
    msgs = _msgs(length)
    got = kd.keccak256_bytes(torch.from_numpy(msgs)).numpy()
    jax_got = np.asarray(jkd.keccak256_bytes(msgs)) if length else None
    for i, m in enumerate(msgs):
        want = ukeccak.keccak256(m.tobytes())
        assert got[i].tobytes() == want
        if jax_got is not None:
            assert jax_got[i].tobytes() == want
    np.testing.assert_array_equal(
        K.hash_rows(torch.from_numpy(msgs)).numpy(), got[:, :25])


def test_gl_to_bytes_is_little_endian():
    vals = np.array([[1, P - 1, 0x0123456789ABCDEF]], dtype=np.uint64)
    got = kd.gl_to_bytes(gl.from_ints(vals)).numpy()
    assert got.tobytes() == b"".join(int(v).to_bytes(8, "little")
                                     for v in vals[0])


def test_permute_twin_matches_jax_host():
    states = _states(40)
    got = _ints(K.permute(gl.from_ints(states)))
    for s, g in zip(states, got):
        want = JKH.permute_host([int(v) for v in s])
        assert [int(v) for v in g] == want == KH.permute_host(
            [int(v) for v in s])


def _reject_some(words):
    """Words of p and above for a quarter of the hash's words: each word
    whose two low bits are 0 gets the top 32 bits and bit 0 set."""
    return [w | REJECT if w & 3 == 0 else w for w in words]


def test_permute_rejection_branch_matches_jax(monkeypatch):
    """Every hash's output changed the same way on both sides (JAX: its
    ``keccak256``; the twin: its ``keccak_f``), so that the sampler sees
    words >= p and both rehash."""
    real_host, real_f = JKH.keccak256, kd.keccak_f

    def host_hash(data):
        h = real_host(data)
        words = [int.from_bytes(h[i:i + 8], "little")
                 for i in range(0, 32, 8)]
        return b"".join(w.to_bytes(8, "little") for w in _reject_some(words))

    def twin_f(state):
        out = real_f(state)
        lanes = out[..., :4]
        rejected = lanes | (REJECT - (1 << 64))
        out[..., :4] = torch.where((lanes & 3) == 0, rejected, lanes)
        return out

    monkeypatch.setattr(JKH, "keccak256", host_hash)
    monkeypatch.setattr(kd, "keccak_f", twin_f)
    states = _states(24, seed=5)
    got = _ints(K.permute(gl.from_ints(states)))
    for s, g in zip(states, got):
        assert [int(v) for v in g] == JKH.permute_host([int(v) for v in s])


# -- the hasher module ---------------------------------------------------------


def test_hasher_host_functions_match_jax():
    rng = np.random.default_rng(3)
    for n in range(0, 12):
        elems = [int(v) for v in rng.integers(0, P, size=n, dtype=np.uint64)]
        assert KH.hash_or_noop_host(elems) == JKH.hash_or_noop_host(elems)
        assert KH.hash_no_pad_host(elems) == JKH.hash_no_pad_host(elems)
        d = KH.hash_no_pad_host(elems)
        assert KH.digest_to_elements(d) == JKH.digest_to_elements(d)
    a, b = KH.hash_no_pad_host([1, 2, 3, 4]), KH.hash_no_pad_host([5])
    assert KH.two_to_one_host(a, b) == JKH.two_to_one_host(a, b)
    assert (KH.HASH_SIZE, KH.WIDTH, KH.RATE, KH.DIGEST_IS_BYTES) == \
        (JKH.HASH_SIZE, JKH.WIDTH, JKH.RATE, JKH.DIGEST_IS_BYTES)


@pytest.mark.parametrize("leaf_len", [1, 3, 4, 6, 17, 135])
def test_device_leaf_hash_matches_host(leaf_len):
    rng = np.random.default_rng(leaf_len)
    leaves = rng.integers(0, P, size=(8, leaf_len), dtype=np.uint64)
    got = KH.hash_or_noop(gl.from_ints(leaves)).numpy()
    assert got.shape == (8, 25) and got.dtype == np.uint8
    for row, g in zip(leaves, got):
        assert g.tobytes() == JKH.hash_or_noop_host([int(v) for v in row])


@pytest.mark.parametrize("cap_height", [0, 1, 4])
def test_merkle_tree_matches_jax_and_rejects_tampered_leaves(cap_height):
    rng = np.random.default_rng(7)
    leaves = rng.integers(0, P, size=(16, 6), dtype=np.uint64)
    tree = merkle.MerkleTree(gl.from_ints(leaves), cap_height, KH)
    cap = tree.cap_host()
    assert cap == JKH.merkle_root_host(
        [[int(v) for v in row] for row in leaves], cap_height)
    assert all(isinstance(d, bytes) and len(d) == 25 for d in cap)
    idx = [0, 5, 15]
    proofs = tree.prove_batch(idx)
    for i, proof in zip(idx, proofs):
        assert len(proof) == 4 - cap_height
        assert all(isinstance(d, bytes) for d in proof)
        leaf = [int(v) for v in leaves[i]]
        assert merkle.verify_merkle_proof_to_cap(leaf, i, cap, proof, KH)
        bad = list(leaf)
        bad[0] ^= 1
        assert not merkle.verify_merkle_proof_to_cap(bad, i, cap, proof, KH)
        if proof:
            sib = list(proof)
            sib[0] = bytes([sib[0][0] ^ 1]) + sib[0][1:]
            assert not merkle.verify_merkle_proof_to_cap(leaf, i, cap, sib,
                                                         KH)


def test_merkle_levels_twin_matches_host_pairs():
    d0 = torch.from_numpy(_msgs(25, n=32))
    levels = K.merkle_levels(d0, 3)
    cur = [bytes(r.tobytes()) for r in d0.numpy()]
    for level in levels:
        cur = [KH.two_to_one_host(cur[2 * i], cur[2 * i + 1])
               for i in range(len(cur) // 2)]
        assert [bytes(r.tobytes()) for r in level.numpy()] == cur


def test_challenger_observes_byte_digests_as_jax():
    from plonky2_goldibear_tpu.hash.challenger import \
        Challenger as JChallenger

    d1, d2 = KH.hash_no_pad_host([1, 2]), KH.hash_no_pad_host([3] * 9)
    port = Challenger(host.GOLDILOCKS, KH)
    jax_ = JChallenger(JKH.permute_host, JKH.WIDTH, JKH.RATE,
                       host.GOLDILOCKS)
    for ch in (port, jax_):
        ch.observe_hash(d1)
        ch.observe_cap([d2, d1])
        ch.observe_element(5)
    assert port.get_n_challenges(9) == jax_.get_n_challenges(9)


# -- the CUDA source on the host -------------------------------------------


def _source() -> str:
    with open(SOURCE) as f:
        return f.read()


def test_cuda_source_round_constants():
    m = re.search(r"__constant__ uint64_t RC\[24\] = \{([^}]*)\};", _source())
    assert m
    assert [int(x.strip().rstrip("ul"), 16) for x in m.group(1).split(",")] \
        == ukeccak._RC
    assert K.DIGEST == KH.HASH_SIZE == 25


_STUB = r"""
#pragma once
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __launch_bounds__(x)
#define __ldg(p) (*(p))
struct dim3_ { unsigned x, y, z; };
extern dim3_ threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << (s & 31)) >> 32);
}
// a launch: the kernel body once for each thread of the grid, in turn
template <class F> void host_launch(unsigned grid, unsigned block, F f) {
  blockDim = {block, 1, 1};
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned t = 0; t < block; ++t) {
      blockIdx = {b, 0, 0};
      threadIdx = {t, 0, 0};
      f();
    }
}
"""

# mode rows (n, len, aligned), merkle (n, layers) or permute (n): the
# input's bytes on stdin, the output's on stdout
_HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
#ifdef REJECT_SOME
// the test's change of each hash's output: see _reject_some
static void reject_some(uint64_t* s) {
  for (int i = 0; i < 4; ++i)
    if ((s[i] & 3) == 0) s[i] |= 0xFFFFFFFF00000001ull;
}
#define ONION_TEST_HOOK(s) reject_some(s)
#endif
#include "keccak_host.cpp"
dim3_ threadIdx, blockIdx, blockDim;
int main(int argc, char** argv) {
  const long long n = atoll(argv[2]);
  const int a = argc > 3 ? atoi(argv[3]) : 0;
  const int aligned = argc > 4 ? atoi(argv[4]) : 0;
  std::vector<uint8_t> in((size_t)1 << 24), out((size_t)1 << 24);
  const size_t got = fread(in.data(), 1, in.size(), stdin);
  int err = 0;
  size_t out_len = 0;
  switch (argv[1][0]) {
    case 'r':
      err = keccak_rows(in.data(), out.data(), n, a, 25, aligned, nullptr);
      out_len = n * 25;
      break;
    case 'm':
      err = keccak_merkle_levels(in.data(), out.data(), n, a, nullptr);
      out_len = (n - (n >> a)) * 25;
      break;
    default:
      err = keccak_permute((const uint64_t*)in.data(),
                           (uint64_t*)out.data(), n, nullptr);
      out_len = n * 96;
  }
  (void)got;
  if (err) return 2;
  fwrite(out.data(), 1, out_len, stdout);
  return 0;
}
"""


def _launches_as_loops(src: str) -> str:
    """Each ``kernel<<<grid, THREADS, 0, stream>>>(args);`` as a
    ``host_launch`` of the kernel's body over the grid."""
    src, n = re.subn(
        r"(\w+(?:<\w+>)?)<<<(.*?),\s*THREADS,\s*0,\s*.*?>>>\((.*?)\);",
        r"host_launch(\2, THREADS, [&] { \1(\3); });", src, flags=re.S)
    assert n == 4, "the launches of csrc/keccak.cu changed"
    return src


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """(plain harness, harness with the rejecting hook), built from the
    source as it is."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the device code for the host")
    d = tmp_path_factory.mktemp("keccak_host")
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "keccak_host.cpp").write_text(_launches_as_loops(_source()))
    (d / "harness.cpp").write_text(_HARNESS)
    exes = []
    for name, flags in (("plain", []), ("reject", ["-DREJECT_SOME"])):
        exe = str(d / name)
        subprocess.run([gxx, "-std=c++17", "-O1", "-w", *flags, "-I", str(d),
                        str(d / "harness.cpp"), "-o", exe], check=True,
                       capture_output=True, timeout=300)
        exes.append(exe)
    return exes


def _run(exe, data: bytes, *args) -> bytes:
    return subprocess.run([exe, *map(str, args)], input=data,
                          capture_output=True, check=True,
                          timeout=120).stdout


@pytest.mark.parametrize("length", LENGTHS)
def test_device_rows_on_host(harness, length):
    msgs = _msgs(length, n=130)
    want = K.hash_rows_plain(torch.from_numpy(msgs)).numpy()
    for aligned in ((0, 1) if length % 8 == 0 else (0,)):
        out = _run(harness[0], msgs.tobytes(), "rows", len(msgs), length,
                   aligned)
        np.testing.assert_array_equal(
            np.frombuffer(out, dtype=np.uint8).reshape(-1, 25), want)


def test_device_merkle_levels_on_host(harness):
    d0 = _msgs(25, n=256)
    want = K.merkle_levels_plain(torch.from_numpy(d0), 5)
    out = _run(harness[0], d0.tobytes(), "merkle", 256, 5)
    np.testing.assert_array_equal(
        np.frombuffer(out, dtype=np.uint8).reshape(-1, 25),
        torch.cat(want).numpy())


@pytest.mark.parametrize("reject", [False, True],
                         ids=["plain", "words_of_p_and_above"])
def test_device_permute_on_host(harness, reject, monkeypatch):
    states = _states(40, seed=9)
    out = np.frombuffer(_run(harness[reject], states.tobytes(), "permute",
                             len(states)), dtype=np.uint64).reshape(-1, 12)
    if reject:
        real = JKH.keccak256

        def host_hash(data):
            h = real(data)
            words = [int.from_bytes(h[i:i + 8], "little")
                     for i in range(0, 32, 8)]
            return b"".join(w.to_bytes(8, "little")
                            for w in _reject_some(words))

        monkeypatch.setattr(JKH, "keccak256", host_hash)
    for s, g in zip(states, out):
        assert [int(v) for v in g] == JKH.permute_host([int(v) for v in s])


def test_sass_keccak_round_reader():
    """The SASS reader of ``probes sass`` takes the smallest loop of 100 or
    more instructions as the 24-trip round loop: here a block loop of 150
    around a round loop of 120, after a short loop."""
    from plonky2_goldibear_torch import probes as runner

    code = [(16 * i, "LOP3.LUT R1, R2, R3, R4, 0x96, !PT") for i in range(200)]
    code[10] = (160, "BRA 0x0")                  # a short loop
    code[170] = (16 * 170, "BRA 0x300")          # the rounds: 0x30 .. 170
    code[180] = (16 * 180, "BRA 0x1e0")          # the block: 0x1e .. 180
    rec = runner.keccak_rounds(code)
    assert rec["round_loop"] == 170 - 0x30 + 1
    assert rec["per_keccak_f"] == 24 * rec["round_loop"]
    assert rec["opcodes"]["LOP3"] == rec["round_loop"] - 1
