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
  a stub of the CUDA runtime (each launch runs its blocks in turn, a
  block's threads at once as host threads, so that ``__syncwarp`` and
  ``__syncthreads`` are barriers and ``__shared__`` arrays are shared):
  its entry points against the twin and the JAX host functions, the rows
  and a Merkle level at every group size (1 and 25 threads a state) and at
  the byte alignments that take different loads, the subtree launch at
  every depth, whole trees as ``merkle_plan`` launches them (both groups
  and the subtree in one tree), the rejection branch through the source's
  ``ONION_TEST_HOOK``; skipped without ``g++``.  The round
  constants, rho offsets and geometry constants written in the source
  equal ``utils/keccak.py``'s and the wrapper's.
- The pure plans of ``ops/keccak.py``: every level of trees of 2^1 to
  2^17 leaves to caps 1 and 16 launched once, in order; the groups of the
  prove's shapes; a plan that leaves a level out refused.
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
#include <barrier>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __restrict__
#define __launch_bounds__(x)
#define __ldg(p) (*(p))
struct dim3_ { unsigned x, y, z; };
extern thread_local dim3_ threadIdx;
extern dim3_ blockIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << (s & 31)) >> 32);
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31));
}
// a block's barriers: __syncthreads over all its threads, __syncwarp over
// the threads of its mask in the caller's warp
struct BlockSync {
  std::barrier<> block;
  std::mutex mu;
  std::map<uint64_t, std::unique_ptr<std::barrier<>>> warps;
  explicit BlockSync(unsigned n) : block(n) {}
};
extern BlockSync* g_sync;
inline void __syncthreads() { g_sync->block.arrive_and_wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  const uint64_t key = (uint64_t)(threadIdx.x >> 5) << 32 | mask;
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(g_sync->mu);
    auto& slot = g_sync->warps[key];
    if (!slot) slot = std::make_unique<std::barrier<>>(__builtin_popcount(mask));
    b = slot.get();
  }
  b->arrive_and_wait();
}
// a launch: the blocks in turn, each block's threads at once (one host
// thread each, so that barriers and shared memory act as on the card)
template <class F> void host_launch(unsigned grid, unsigned block, F f) {
  blockDim = {block, 1, 1};
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx = {b, 0, 0};
    BlockSync sync(block);
    g_sync = &sync;
    std::vector<std::thread> th;
    for (unsigned t = 0; t < block; ++t)
      th.emplace_back([&f, t] { threadIdx = {t, 0, 0}; f(); });
    for (auto& x : th) x.join();
  }
}
"""

# modes, the input's bytes on stdin (from byte `offset` of the buffer),
# the output's on stdout:
#   rows n len aligned [group threads offset]
#   merkle n layers (one level launch of one thread a state per layer)
#   run n out_digests offset step words ... (keccak_merkle_run's list)
#   permute n
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
thread_local dim3_ threadIdx;
dim3_ blockIdx, blockDim;
BlockSync* g_sync;
int main(int argc, char** argv) {
  const char mode = argv[1][0];
  const long long n = atoll(argv[2]);
  const long long a = argc > 3 ? atoll(argv[3]) : 0;
  int offset = 0;
  if (mode == 'r' && argc > 7) offset = atoi(argv[7]);
  if (mode == 'u') offset = atoi(argv[4]);
  std::vector<uint8_t> in((size_t)1 << 24), out((size_t)1 << 24);
  const size_t got = fread(in.data() + offset, 1, in.size() - offset, stdin);
  (void)got;
  int err = 0;
  size_t out_len = 0;
  switch (mode) {
    case 'r': {
      const int aligned = argc > 4 ? atoi(argv[4]) : 0;
      const int group = argc > 5 ? atoi(argv[5]) : 1;
      const int threads = argc > 6 ? atoi(argv[6]) : 128;
      err = keccak_rows(in.data() + offset, out.data(), n, (int)a, 25,
                        aligned, group, threads, nullptr);
      out_len = n * 25;
      break;
    }
    case 'm': {
      std::vector<long long> steps;
      long long src = -1, dst = 0;
      for (long long k = 0, parents = n / 2; k < a; ++k, parents /= 2) {
        steps.insert(steps.end(), {0, src, dst, parents, 1, 128});
        src = dst;
        dst += parents * 25;
      }
      err = keccak_merkle_run(in.data(), out.data(), steps.data(),
                              (int)a, nullptr);
      out_len = (n - (n >> a)) * 25;
      break;
    }
    case 'u': {
      std::vector<long long> steps;
      for (int k = 5; k < argc; ++k) steps.push_back(atoll(argv[k]));
      err = keccak_merkle_run(in.data() + offset, out.data(), steps.data(),
                              (int)(steps.size() / 6), nullptr);
      out_len = a * 25;
      break;
    }
    default:
      err = keccak_permute((const uint64_t*)in.data(),
                           (uint64_t*)out.data(), n, nullptr);
      out_len = n * 96;
  }
  if (err) return 2;
  fwrite(out.data(), 1, out_len, stdout);
  return 0;
}
"""


def _launch_args(inside: str):
    """The top-level comma-separated parts of a launch's <<<...>>>."""
    parts, depth, cur = [], 0, ""
    for ch in inside:
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
            continue
        depth += ch == "("
        depth -= ch == ")"
        cur += ch
    return parts + [cur.strip()]


def _launches_as_loops(src: str) -> str:
    """Each ``kernel<<<grid, block, 0, stream>>>(args);`` as a
    ``host_launch`` of the kernel's body over the grid, a block's threads
    at once."""
    def repl(m):
        grid, block = _launch_args(m.group(2))[:2]
        return (f"host_launch({grid}, {block}, [&] {{ "
                f"{m.group(1)}({m.group(3)}); }});")

    src, n = re.subn(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);", repl, src,
                     flags=re.S)
    assert n == 5, "the launches of csrc/keccak.cu changed"
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
        subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-pthread", *flags,
                        "-I", str(d), str(d / "harness.cpp"), "-o", exe],
                       check=True, capture_output=True, timeout=300)
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


# every group size, at row lengths around the rate's edges, aligned and
# from a start off an 8-byte boundary (the byte loads); 7 rows leave a
# one-thread block's last warp part full, 3 a 25-thread block's last
# warp empty (two warps a block)
GROUP_LENGTHS = (0, 7, 50, 135, 136, 137, 272)
H100_SMS = 132


def _digests(out: bytes) -> np.ndarray:
    return np.frombuffer(out, dtype=np.uint8).reshape(-1, 25)


@pytest.mark.parametrize("length", GROUP_LENGTHS)
@pytest.mark.parametrize("group", K.GROUPS)
def test_device_group_rows_on_host(harness, group, length):
    msgs = _msgs(length, n=7 if group == 1 else 3)
    want = K.hash_rows_plain(torch.from_numpy(msgs)).numpy()
    for aligned, offset in (((1, 0), (0, 1)) if length % 8 == 0 else
                            ((0, 0), (0, 3))):
        out = _run(harness[0], msgs.tobytes(), "rows", len(msgs), length,
                   aligned, group, 64, offset)
        np.testing.assert_array_equal(_digests(out), want)


def _run_plan(exe, d0: np.ndarray, plan, offset=0) -> np.ndarray:
    """The launches of ``plan`` through ``keccak_merkle_run``, d0 placed
    ``offset`` bytes past an aligned address: all levels, back to back."""
    widths, steps, _, _ = K._launches_of(len(d0), tuple(plan))
    out = _run(exe, d0.tobytes(), "u", len(d0), sum(widths), offset,
               *list(steps))
    return _digests(out)


@pytest.mark.parametrize("group", K.GROUPS)
def test_device_level_on_host(harness, group):
    """One level launch of each group: 5 parents (a block's last warp part
    full at one thread a state, empty at 25), d0 at the byte alignments of
    its 32-bit words that load differently (a shift of 0, 16, 24 bits)."""
    d0 = _msgs(25, n=10)
    want = K.hash_rows_plain(torch.from_numpy(d0).reshape(5, 50)).numpy()
    for offset in (0, 2, 3):
        got = _run_plan(harness[0], d0, (("level", 5, group, 64),), offset)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layers", range(1, K.TAIL_LAYERS + 1))
def test_device_subtree_on_host(harness, layers):
    """A subtree launch of each depth: two subtrees (the second block's
    slices of each level), d0 off an aligned word by layers % 4 bytes."""
    n = 2 << layers
    d0 = _msgs(25, n=n)
    want = torch.cat(K.merkle_levels_plain(torch.from_numpy(d0),
                                           layers)).numpy()
    got = _run_plan(harness[0], d0, (("subtree", n, layers),),
                    offset=layers % 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,cap,sms", [(2, 1, H100_SMS), (32, 16, H100_SMS),
                                       (64, 1, 2), (128, 16, 4)])
def test_device_merkle_plan_on_host(harness, n, cap, sms):
    """Whole trees as ``merkle_plan`` launches them, down to a cap of 1 or
    16: on the H100's 132 SMs (a subtree launch alone), and on 2 or 4 SMs,
    where the wide levels (15 parents an SM and more) take one thread a
    state, narrower ones 25, and the top levels a subtree launch."""
    layers = (n // cap).bit_length() - 1
    d0 = _msgs(25, n=n)
    want = torch.cat(K.merkle_levels_plain(torch.from_numpy(d0),
                                           layers)).numpy()
    plan = K.merkle_plan(n, layers, sms)
    assert plan[-1][0] == "subtree"
    if sms == 2:
        assert [s[2] for s in plan[:-1]] == list(K.GROUPS)
    got = _run_plan(harness[0], d0, plan, offset=1)
    np.testing.assert_array_equal(got, want)


# -- launch geometry (pure) ---------------------------------------------------


@pytest.mark.parametrize("bits,cap", [(b, 1) for b in range(1, 18)] +
                         [(b, 16) for b in range(4, 18)])
def test_merkle_plan_covers_every_level(bits, cap):
    """Every level from n / 2 to the cap, in order: a launch a level, then
    the top levels that take 25 threads a state (TAIL_LAYERS at most) as
    one subtree launch; every launch one the source takes; a tree of
    n = cap has no launch."""
    n = 1 << bits
    layers = bits - (cap.bit_length() - 1)
    if layers == 0:
        assert K.merkle_plan(n, 0, H100_SMS) == ()
        return
    for sms in (H100_SMS, 1, 1024):
        plan = K.merkle_plan(n, layers, sms)
        widths, _, n_level, n_subtree = K._launches_of(n, plan)
        assert widths == [n >> (k + 1) for k in range(layers)]
        assert n_subtree <= 1 and n_level + n_subtree == len(plan)
        for step in plan[:n_level]:
            _, parents, g, threads = step
            assert step[0] == "level" and g == K.group_for(parents, sms)
            assert threads % 32 == 0 and 32 <= threads <= K.MAX_THREADS
        k = plan[-1][2] if n_subtree else 0
        assert k == min(layers, K.TAIL_LAYERS) or \
            K.group_for(cap << k, sms) == 1
        if k:
            assert K.group_for(cap << (k - 1), sms) == 25


def test_merkle_plan_of_the_prove():
    """The 2^15-leaf trees of a Keccak outer prove to a cap of 16 take
    fewer launches than their 11 levels, the widest at a thread a parent;
    the FRI layers' trees (2^11, 2^7) and the small circuit's (2^6) end in
    one subtree launch of 4, 3 and 2 levels."""
    plan = K.merkle_plan(1 << 15, 11, H100_SMS)
    assert len(plan) == 8 and plan[0][2] == 1
    for n, layers in ((1 << 15, 11), (1 << 11, 7), (1 << 7, 3), (1 << 6, 2)):
        assert K.merkle_plan(n, layers, H100_SMS)[-1] == \
            ("subtree", 16 << min(layers, 4), min(layers, 4))


def test_plans_never_leave_a_level_out():
    """A plan with a level missing, a level off half its input's width, or
    a launch the source does not take, is refused before anything is
    launched."""
    plan = K.merkle_plan(1 << 11, 7, H100_SMS)
    for bad in (plan[1:], plan[:1] + plan[2:],
                (("level", 1 << 9, 1, 128),), (("level", 1 << 10, 5, 128),),
                (("level", 1 << 10, 1, 48),),
                (("level", 1 << 10, 1, 128), ("subtree", 1 << 11, 4)),
                (("subtree", 1 << 11, K.TAIL_LAYERS + 1),),
                (("subtree", 24, 4),), (("tail", 1 << 11, 4),)):
        with pytest.raises(ValueError):
            K._launches_of(1 << 11 if bad[0][1] != 24 else 24, bad)


def test_group_for_the_prove_shapes():
    """Groups grow as launches narrow; the 2^15-row leaves, the first FRI
    layer's 2^11 rows and the Merkle levels of 2^11 parents and more keep
    a thread a state (the keccak_groups sweep: a 25-thread group is slower
    there), the last FRI layer's 2^7 rows and the narrow levels take a
    group."""
    groups = [K.group_for(1 << k, H100_SMS) for k in range(18)]
    assert groups == sorted(groups, reverse=True)
    g, threads = K.launch_plan(1 << 15, H100_SMS)
    assert g == 1 and threads % 32 == 0
    for k in range(11, 18):
        assert K.group_for(1 << k, H100_SMS) == 1
    assert K.launch_plan(1 << 11, H100_SMS)[0] == 1
    assert K.launch_plan(1 << 7, H100_SMS)[0] > 1
    assert K.group_for(1 << 10, H100_SMS) > 1
    assert all(K.threads_for(s, g) % 32 == 0 and
               K.threads_for(s, g) >= s * g for s in (1, 7, 100)
               for g in K.GROUPS)


def test_cuda_source_geometry_constants():
    src = _source()
    for name, want in (("SUBTREE_MAX_LAYERS", K.TAIL_LAYERS),
                       ("MAX_THREADS", K.MAX_THREADS), ("DIGEST", K.DIGEST),
                       ("RATE_BYTES", kd.RATE_BYTES)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == want, name
    m = re.search(r"__constant__ int ROT\[25\] = \{([^}]*)\};", src)
    assert m
    assert [int(x) for x in m.group(1).split(",")] == \
        [ukeccak._ROT[j % 5][j // 5] for j in range(25)]
    for g in K.GROUPS:
        assert 32 // g == K.PER_WARP[g]


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


def test_sass_keccak_group_round_reader():
    """A group kernel's round loop is short (under 100 instructions): the
    reader takes the innermost loop without global loads or stores with
    the most logic ops, here a 40-instruction round loop (it reads the
    round constant) inside a block loop, beside a short loop and a longer
    byte-load loop, and reads the group from the kernel's mangled name."""
    from plonky2_goldibear_torch import probes as runner

    code = [(16 * i, "LOP3.LUT R1, R2, R3, R4, 0x96, !PT") for i in range(200)]
    code[5] = (16 * 5, "BRA 0x0")                   # a short loop, no LDC
    code[30] = (16 * 30, "LDC.64 R2, c[0x3][R4]")   # the round constant
    code[59] = (16 * 59, "BRA 0x140")               # rounds: 0x14 .. 59
    code[100] = (16 * 100, "BRA 0xa0")              # the block: 0xa .. 100
    code[120] = (16 * 120, "LDG.E.U8 R5, desc[UR4][R2.64]")
    code[199] = (16 * 199, "BRA 0x6e0")             # byte loads: 110 .. 199
    rec = runner.keccak_rounds(code)
    assert rec["round_loop"] == 59 - 0x14 + 1 == 40
    assert rec["opcodes"]["LDC"] == 1
    assert runner.keccak_group_of(
        "_ZN12_GLOBAL__N_111rows_kernelILi25ELb1EEEvPKhPhlii") == 25
    assert runner.keccak_group_of(
        "_ZN12_GLOBAL__N_112level_kernelILi1EEEvPKhPhl") == 1
    assert runner.keccak_group_of(
        "_ZN12_GLOBAL__N_114subtree_kernelEPKhPhli") == 25
    assert runner.keccak_group_of(
        "_ZN12_GLOBAL__N_114permute_kernelEPKmPml") == 1
