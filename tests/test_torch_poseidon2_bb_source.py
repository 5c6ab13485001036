"""The Poseidon2-BB CUDA source and its Merkle launch geometry, on the CPU.

- The constants written into ``csrc/poseidon2_bb.cuh`` and ``.cu`` (read
  as text) equal ``hash/_poseidon2_bb_constants.py`` and the wrapper's,
  and the kernels' internal-layer diagonal (the scale folded into each
  2^shift) is the reference's.
- The device code itself, compiled by the host C++ compiler against a stub
  of the CUDA runtime (a warp's shuffles by threads meeting at a barrier),
  runs the permutation for every group size (threads per state); each
  equals ``permute_host`` bit for bit on seeded states.  It runs the leaf
  sponge at every group size on seeded rows and rows of all p - 1 (the
  edge the lazy reductions must survive), at the prove's leaf lengths and
  around the rate; each equals ``hash_leaves_plain`` and the JAX
  package's ``hash/poseidon2_bb.py:hash_no_pad``.  They skip where no
  ``g++`` is found.
- ``merkle_plan`` and ``group_for`` cover every level of the trees of a
  BabyBear prove and spread each over the card; the kernels' constant
  tables (the internal layer's diagonal, its powers and their sums) are
  the reference's.

Tolerance zero throughout: exact field arithmetic.
"""

import os
import re
import shutil
import subprocess

from functools import lru_cache

import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.field import bb as jbb
from plonky2_goldibear_tpu.hash import poseidon2_bb as jp2

from plonky2_goldibear_torch import probes as runner
from plonky2_goldibear_torch.field import bb
from plonky2_goldibear_torch.hash import _poseidon2_bb_constants as C
from plonky2_goldibear_torch.hash import poseidon2_bb as H
from plonky2_goldibear_torch.ops import _build
from plonky2_goldibear_torch.ops import poseidon2_bb as K

SOURCE = os.path.join(_build.CSRC, "poseidon2_bb.cu")
HEADER = os.path.join(_build.CSRC, "poseidon2_bb.cuh")   # the round code
H100_SMS = 132


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _source() -> str:
    return _read(HEADER) + _read(SOURCE)


def _int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _source())
    assert m, name
    return int(m.group(1))


def test_cuda_source_constants():
    assert _int("WIDTH") == C.SPONGE_WIDTH == K.WIDTH
    assert _int("RATE") == C.SPONGE_RATE == K.RATE
    assert _int("HALF_FULL") == C.HALF_N_FULL_ROUNDS
    assert _int("N_FULL") == C.N_FULL_ROUNDS_TOTAL
    assert _int("N_PARTIAL") == C.N_PARTIAL_ROUNDS
    assert _int("DIGEST") == K.NUM_HASH_OUT
    assert _int("SUBTREE_MAX_LAYERS") == K.SUBTREE_MAX_LAYERS
    assert _int("SUBTREE_G") == K.SUBTREE_GROUP
    assert re.findall(r"case (\d+): return launch_level<", _source()) == [
        str(g) for g in K.GROUPS]


def test_scaled_diagonal():
    """Lane i of the kernels' diagonal is INTERNAL_SCALE * 2^shift_(i-1) in
    Montgomery form; lane 0 is unused."""
    got = (K.scaled_diag().astype(np.uint64) * np.uint64(bb.RINV)
           % np.uint64(bb.P)).tolist()
    assert got[0] == 0
    assert got[1:] == [C.INTERNAL_SCALE * (1 << k) % bb.P
                       for k in C.INTERNAL_DIAG_SHIFTS]
    pows, sums = (np.asarray(t, dtype=np.uint64) * np.uint64(bb.RINV)
                  % np.uint64(bb.P) for t in K.diag_powers())
    pows = pows.reshape(16, C.N_PARTIAL_ROUNDS + 1)
    assert not pows[0].any()
    for i in range(1, 16):
        assert pows[i].tolist() == [pow(got[i], k, bb.P)
                                    for k in range(C.N_PARTIAL_ROUNDS + 1)]
    assert sums.tolist() == [sum(pows[1:, j].tolist()) % bb.P
                             for j in range(C.N_PARTIAL_ROUNDS)]


# -- the device code on the host ------------------------------------------

_STUB = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __restrict__
#define __ldg(p) (*(p))
struct dim3_ { unsigned x, y, z; };
extern thread_local dim3_ threadIdx;
extern dim3_ blockIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
extern std::barrier<>* g_bar;
extern uint32_t g_slot[64];
inline uint32_t shfl_at(uint32_t v, int src) {
  g_slot[threadIdx.x] = v;
  g_bar->arrive_and_wait();
  const uint32_t r = g_slot[src];
  g_bar->arrive_and_wait();
  return r;
}
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int width) {
  return shfl_at(v, threadIdx.x / width * width + src);
}
inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int d, int width) {
  return shfl_at(v, threadIdx.x ^ d);
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint64_t)a * b >> 32;
}
template <class A, class B> int cudaMemcpyToSymbol(A& a, B b, unsigned long n) {
  std::memcpy((void*)&a, (const void*)b, n);
  return 0;
}
inline void __syncthreads() {}
"""

# one group: its threads run permute<G> at once
_HARNESS = r"""
#include "poseidon2_bb_host.cpp"
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
thread_local dim3_ threadIdx{0, 0, 0};
dim3_ blockIdx{0, 0, 0}, blockDim{1, 1, 1};
std::barrier<>* g_bar;
uint32_t g_slot[64];
template <int G> void run(uint32_t st[16]) {
  constexpr int L = Group<G>::L;
  std::barrier<> bar(G);
  g_bar = &bar;
  uint32_t out[16];
  std::vector<std::thread> th;
  for (int t = 0; t < G; ++t) th.emplace_back([&, t] {
    threadIdx.x = t;
    Member<G> m(t);
    uint32_t s[L];
    for (int j = 0; j < L; ++j) s[j] = st[m.q * L + j];
    permute<G>(s, m.q, m.mask, Consts<G>(m.q));
    for (int j = 0; j < L; ++j) out[m.q * L + j] = s[j];
  });
  for (auto& x : th) x.join();
  for (int i = 0; i < 16; ++i) st[i] = out[i];
}
// the leaf sponge: leaf i in "block" i of G threads, one block at a time
template <int G>
void sponge(const std::vector<uint32_t>& rows, std::vector<uint32_t>& out,
            long long n, int len, int num_out) {
  blockDim.x = G;
  for (long long i = 0; i < n; ++i) {
    blockIdx.x = unsigned(i);
    std::barrier<> bar(G);
    g_bar = &bar;
    std::vector<std::thread> th;
    for (int t = 0; t < G; ++t) th.emplace_back([&, t] {
      threadIdx.x = t;
      leaf_sponge_kernel<G, true>(rows.data(), out.data(), n, len, num_out);
    });
    for (auto& x : th) x.join();
  }
}
int main(int argc, char** argv) {
  const bool leaves = argv[1][0] == 's';
  const int g = atoi(argv[leaves ? 2 : 1]);
  uint32_t ext[8 * 16], in[13], scale[1], diag[16], pows[16 * 14], sums[13],
      s[16];
  for (auto& x : ext) if (scanf("%u", &x) != 1) return 1;
  for (auto& x : in) if (scanf("%u", &x) != 1) return 1;
  for (auto& x : scale) if (scanf("%u", &x) != 1) return 1;
  for (auto& x : diag) if (scanf("%u", &x) != 1) return 1;
  for (auto& x : pows) if (scanf("%u", &x) != 1) return 1;
  for (auto& x : sums) if (scanf("%u", &x) != 1) return 1;
  poseidon2_bb_set_constants(ext, in, scale, diag, pows, sums);
  if (leaves) {
    const long long n = atoll(argv[3]);
    const int len = atoi(argv[4]), num_out = atoi(argv[5]);
    std::vector<uint32_t> rows(n * len), out(n * num_out);
    for (auto& x : rows) if (scanf("%u", &x) != 1) return 1;
    if (g == 1) sponge<1>(rows, out, n, len, num_out);
    else if (g == 4) sponge<4>(rows, out, n, len, num_out);
    else sponge<16>(rows, out, n, len, num_out);
    for (auto x : out) printf("%u ", x);
    printf("\n");
    return 0;
  }
  while (true) {
    for (auto& x : s) if (scanf("%u", &x) != 1) return 0;
    if (g == 1) run<1>(s); else if (g == 4) run<4>(s); else run<16>(s);
    for (auto x : s) printf("%u ", x);
    printf("\n");
  }
}
"""


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    """The harness built from the source as it is."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the device code for the host")
    d = tmp_path_factory.mktemp("poseidon2_bb_host")
    src = re.sub(r"<<<.*?>>>", "", _read(SOURCE), flags=re.S)
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "poseidon2_bb_host.cpp").write_text(src)
    (d / "harness.cpp").write_text(_HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-pthread",
                    "-I", str(d), "-I", _build.CSRC,
                    str(d / "harness.cpp"), "-o", exe],
                   check=True, capture_output=True, timeout=300)
    return exe


def _mont(vals) -> np.ndarray:
    return K._mont_array(vals)


def _constants_text() -> str:
    consts = [_mont(C.EXTERNAL_CONSTANTS), _mont(C.INTERNAL_CONSTANTS),
              _mont([C.INTERNAL_SCALE]), K.scaled_diag(), *K.diag_powers()]
    return "\n".join(" ".join(map(str, c.tolist())) for c in consts)


@pytest.mark.parametrize("group", K.GROUPS + (K.SUBTREE_GROUP,))
def test_device_permutation_on_host(host_binary, group):
    """Each group size the kernels are built for: the levels' (1, 4) and
    the subtrees' (16, with the partial rounds' single reduction)."""
    rng = np.random.default_rng(group)
    states = rng.integers(0, H.P, size=(24, 16), dtype=np.uint64).tolist()
    states += [[H.P - 1] * 16, [0] * 16, list(range(16))]
    text = _constants_text() + "\n" + "\n".join(
        " ".join(map(str, _mont(s).tolist())) for s in states)
    out = subprocess.run([host_binary, str(group)], input=text,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split("\n")
    for state, line in zip(states, out):
        got = [int(x) * bb.RINV % bb.P for x in line.split()]
        assert got == H.permute_host(state)


# the sponge's leaf lengths: one element, the rate and one past it, the FRI
# leaves (32), the prove's Z / partial-product (36), quotient (48) and wire
# (167) leaves
SPONGE_LENGTHS = (1, 8, 9, 32, 36, 48, 167)


@lru_cache(maxsize=None)
def _sponge_case(length):
    """Three seeded rows and one of all p - 1 (canonical), and the JAX
    hash_no_pad of each."""
    import jax

    rows = np.random.default_rng(length).integers(
        0, H.P, size=(4, length), dtype=np.uint64)
    rows[3] = H.P - 1
    ref = jbb.to_ints(jax.jit(jp2.hash_no_pad)(jbb.from_ints(rows)))
    return rows, np.asarray(ref, dtype=np.uint64)


@pytest.mark.parametrize("length", SPONGE_LENGTHS)
@pytest.mark.parametrize("group", K.SPONGE_GROUPS)
def test_device_sponge_on_host(host_binary, group, length):
    rows, ref = _sponge_case(length)
    torch.set_num_threads(1)
    plain = bb.to_ints(K.hash_leaves_plain(bb.from_ints(rows)))
    np.testing.assert_array_equal(plain, ref)
    text = _constants_text() + "\n" + " ".join(
        map(str, _mont(rows).tolist()))
    out = subprocess.run(
        [host_binary, "sponge", str(group), str(len(rows)), str(length),
         str(K.NUM_HASH_OUT)], input=text, capture_output=True, text=True,
        check=True, timeout=120).stdout
    got = (np.array(out.split(), dtype=np.uint64) * np.uint64(bb.RINV)
           % np.uint64(bb.P)).reshape(ref.shape)
    np.testing.assert_array_equal(got, ref)


# -- launch geometry -------------------------------------------------------

# the trees of a BabyBear 2^12 prove (wires, Z/partial products, quotient:
# 2^15 leaves; the FRI layers of arity 2^3: 2^12, 2^9, 2^6 leaves), all to
# a cap of 16, and trees of other caps
TREES = [(1 << 15, 11), (1 << 12, 8), (1 << 9, 5), (1 << 6, 2),
         (1 << 15, 15), (16, 4), (2, 1), (1 << 20, 16)]


@pytest.mark.parametrize("n,layers", TREES)
def test_merkle_plan_covers_every_level(n, layers):
    plan = K.merkle_plan(n, layers, H100_SMS)
    width, done = n, 0
    for step in plan:
        if step[0] == "level":
            _, parents, g, threads = step
            assert parents == width // 2 and g in K.GROUPS
            assert g != K.SUBTREE_GROUP
            assert threads % 32 == 0 and 32 <= threads <= 128
            width, done = parents, done + 1
        else:
            _, w, sub_layers, subtrees, threads = step
            assert w == width and 1 <= sub_layers <= K.SUBTREE_MAX_LAYERS
            assert subtrees == width >> sub_layers >= n >> layers
            assert threads == K.SUBTREE_GROUP << (sub_layers - 1) <= 1024
            width, done = subtrees, done + sub_layers
    assert done == layers and width == n >> layers
    assert plan[-1][0] == "subtree" and plan[-1][3] == n >> layers


@pytest.mark.parametrize("n,layers", TREES[:4])
def test_merkle_plan_spreads_the_prove_trees(n, layers):
    """Every level launch of a prove tree fills every SM with FILL_PER_SM
    threads and gives each a block; the narrower levels run as subtrees of
    16 threads a parent, at most two launches of them, the last one block
    per node of the cap."""
    plan = K.merkle_plan(n, layers, H100_SMS)
    for step in plan:
        if step[0] == "level":
            _, parents, g, threads = step
            assert parents * g >= K.FILL_PER_SM * H100_SMS
            assert -(-parents * g // threads) >= H100_SMS
    subtrees = [s for s in plan if s[0] == "subtree"]
    assert 1 <= len(subtrees) <= 2 and subtrees[-1][3] == 16


def test_group_and_block_choice():
    assert K.group_for(1 << 15, H100_SMS) == 1
    assert K.group_for(1 << 14, H100_SMS) == 4
    assert K.group_for(1 << 12, H100_SMS) == 4
    # a level of 4096 parents no longer fills the card at 4 threads a state:
    # the 2^15-leaf tree runs two level launches, then its subtrees
    assert [s[0] for s in K.merkle_plan(1 << 15, 11, H100_SMS)] == [
        "level", "level", "subtree", "subtree"]
    assert K.block_for(1 << 15, H100_SMS) == 128
    assert K.block_for(4096, H100_SMS) == 32


def test_group_sweep_needs_the_card():
    import torch

    with pytest.raises(ValueError, match="needs the card"):
        runner.run_poseidon2_groups(torch.device("cpu"))


def test_sass_per_permutation_reader_poseidon2():
    """A Poseidon2-BB library's round loops count 4, 13 and 4 trips; the
    library is told by its file name."""
    code, addr = [], 0

    def emit(insn):
        nonlocal addr
        code.append((addr, insn))
        addr += 16

    emit("LDC R1, c[0x0][0x28]")
    for body in (130, 105, 130):
        start = addr
        for i in range(body - 1):
            emit("IMNMX.U32 R4, R2, R4, PT" if i % 2 else
                 "IMAD.WIDE.U32 R4, R2, R3, R4")
        emit(f"@P1 BRA 0x{start:x}")
    emit("EXIT")
    trips = runner.ROUND_TRIPS[runner._library_of(
        "/x/libposeidon2_bb_0123456789ab.so")]
    assert trips == (4, 13, 4)
    assert runner._library_of("/x/libposeidon_gl_0123.so") == "poseidon_gl"
    rec = runner.per_permutation(code, trips)
    assert rec["round_loops"] == [130, 105, 130]
    assert rec["instructions"] == len(code) + 3 * 130 + 12 * 105 + 3 * 130
    assert rec["split"]["IMNMX"] == 64 * 4 + 52 * 13 + 64 * 4
    assert sum(rec["split"].values()) == rec["instructions"]


def test_sponge_plan_spreads_the_prove_sponges():
    """The sponge's group: one thread where the leaves fill the card, more
    for the narrow FRI layers; blocks of whole groups."""
    for n in (1 << 15, 1 << 12, 1 << 9, 1 << 6, 5):
        g, threads = K.sponge_plan(n, H100_SMS)
        assert g in K.SPONGE_GROUPS
        assert threads % 32 == 0 and 32 <= threads <= 128
        assert g == K.group_for(n, H100_SMS, K.SPONGE_GROUPS,
                                K.SPONGE_FILL_PER_SM)
    assert K.sponge_plan(1 << 15, H100_SMS)[0] == 1
    assert K.sponge_plan(1 << 6, H100_SMS)[0] == K.SPONGE_GROUPS[-1]
    assert re.findall(r"case (\d+): return launch_sponge<", _source()) == [
        str(g) for g in K.SPONGE_GROUPS]
