"""The Poseidon-GL CUDA source and its launch geometry, on the CPU.

- The constants written into ``csrc/poseidon_gl.cuh`` and ``.cu`` (read as
  text) equal
  ``hash/_poseidon_gl_constants.py`` and the wrapper's.
- The device code itself, compiled by the host C++ compiler against a stub
  of the CUDA runtime (the launches and the one inline PTX instruction
  replaced by plain C++, a warp's shuffles by threads meeting at a
  barrier), runs the permutation for every group size (threads per
  state); each equals ``permute_host`` bit for bit on seeded states.
  They skip where no ``g++`` is found.
- ``merkle_plan`` and ``group_for`` spread every level of the prove's
  trees over the card, and the SASS reader counts a permutation from the
  round loops.

Tolerance zero throughout: exact field arithmetic.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

from plonky2_goldibear_torch import probes as runner
from plonky2_goldibear_torch.hash import _poseidon_gl_constants as C
from plonky2_goldibear_torch.hash import poseidon_gl as H
from plonky2_goldibear_torch.ops import _build
from plonky2_goldibear_torch.ops import poseidon_gl as K

SOURCE = os.path.join(_build.CSRC, "poseidon_gl.cu")
HEADER = os.path.join(_build.CSRC, "poseidon_gl.cuh")   # the round code
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


def _array(name: str):
    m = re.search(rf"constexpr uint32_t {name}\[WIDTH\] = \{{([^}}]*)\}};",
                  _source())
    assert m, name
    return [int(x) for x in m.group(1).split(",")]


def test_cuda_source_constants():
    assert _int("WIDTH") == C.SPONGE_WIDTH == K.WIDTH
    assert _int("RATE") == C.SPONGE_RATE == K.RATE
    assert _int("HALF_FULL") == C.HALF_N_FULL_ROUNDS
    assert _int("N_PARTIAL") == C.N_PARTIAL_ROUNDS
    assert _int("DIGEST") == K.NUM_HASH_OUT
    assert _int("TAIL_MAX_LAYERS") == K.TAIL_MAX_LAYERS
    assert _array("CIRC") == list(C.MDS_MATRIX_CIRC)
    assert _array("DIAG") == list(C.MDS_MATRIX_DIAG)


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
struct alignas(16) uint4 { unsigned x, y, z, w; };
extern thread_local dim3_ threadIdx;
extern dim3_ blockIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
extern std::barrier<>* g_bar;
extern uint64_t g_slot[64];
template <class T> T __shfl_sync(unsigned, T v, int src, int width) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_slot[threadIdx.x] = u;
  g_bar->arrive_and_wait();
  uint64_t r = g_slot[threadIdx.x / width * width + src];
  g_bar->arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return (unsigned __int128)a * b >> 64;
}
template <class A, class B> int cudaMemcpyToSymbol(A& a, B b, unsigned long n) {
  std::memcpy((void*)&a, (const void*)b, n);
  return 0;
}
inline void __syncthreads() {}
"""

# one block of one group: the group's threads run permute<G> at once
_HARNESS = r"""
#include "poseidon_gl_host.cpp"
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
thread_local dim3_ threadIdx{0, 0, 0};
dim3_ blockIdx{0, 0, 0}, blockDim{1, 1, 1};
std::barrier<>* g_bar;
uint64_t g_slot[64];
template <int G> void run(uint64_t st[12]) {
  constexpr int SPAN = Group<G>::SPAN, L = Group<G>::L;
  std::barrier<> bar(SPAN);
  g_bar = &bar;
  uint64_t out[12];
  std::vector<std::thread> th;
  for (int t = 0; t < SPAN; ++t) th.emplace_back([&, t] {
    threadIdx.x = t;
    static uint4 smem[RC2_WORDS / 4];
    const uint32_t* rc2 = rc2_to_shared<G>(smem);
    Member<G> m(t);
    uint64_t s[L];
    for (int j = 0; j < L; ++j) s[j] = st[m.q + G * j];
    permute<G>(s, m.q, m.mask, rc2);
    if (!m.spare) for (int j = 0; j < L; ++j) out[m.q + G * j] = s[j];
  });
  for (auto& x : th) x.join();
  for (int i = 0; i < 12; ++i) st[i] = out[i];
}
int main(int argc, char** argv) {
  const int g = atoi(argv[1]);
  uint64_t rc[N_ROUNDS * WIDTH], s[12];
  for (auto& x : rc) if (scanf("%lu", &x) != 1) return 1;
  poseidon_gl_set_constants(rc);
  while (true) {
    for (auto& x : s) if (scanf("%lu", &x) != 1) return 0;
    if (g == 1) run<1>(s); else if (g == 2) run<2>(s);
    else if (g == 4) run<4>(s); else run<12>(s);
    for (auto x : s) printf("%lu ", x);
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
    d = tmp_path_factory.mktemp("poseidon_gl_host")
    src = re.sub(r"<<<.*?>>>", "", _read(SOURCE), flags=re.S)
    header, n = re.subn(
        r'asm\("mad\.lo\.u32 %0, %1, %2, %0;" : "\+r"\(acc\) : "r"\(x\), '
        r'"n"\(C\)\);', "acc += x * C;", _read(HEADER))
    assert n == 1, "the inline PTX of csrc/poseidon_gl.cuh changed"
    (d / "cuda_runtime.h").write_text(_STUB)
    # the patched header beside the source, found before csrc's
    (d / "poseidon_gl.cuh").write_text(header)
    (d / "poseidon_gl_host.cpp").write_text(src)
    (d / "harness.cpp").write_text(_HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-pthread",
                    "-I", str(d), "-I", _build.CSRC,
                    str(d / "harness.cpp"), "-o", exe],
                   check=True, capture_output=True, timeout=300)
    return exe


@pytest.mark.parametrize("group", K.GROUPS,
                         ids=[f"default-{g}" for g in K.GROUPS])
def test_device_permutation_on_host(host_binary, group):
    rng = np.random.default_rng(group)
    states = rng.integers(0, H.P, size=(24, 12), dtype=np.uint64).tolist()
    states += [[H.P - 1] * 12, [0] * 12]
    text = " ".join(map(str, C.ALL_ROUND_CONSTANTS)) + "\n" + "\n".join(
        " ".join(map(str, s)) for s in states)
    out = subprocess.run([host_binary, str(group)], input=text,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split("\n")
    for state, line in zip(states, out):
        assert [int(x) for x in line.split()] == H.permute_host(state)


# -- launch geometry -------------------------------------------------------


@pytest.mark.parametrize("n,layers", [(1 << 15, 11), (1 << 15, 15),
                                      (1 << 11, 7), (1 << 7, 3), (1 << 6, 2),
                                      (16, 4), (2, 1), (1 << 20, 16)])
def test_merkle_plan_covers_every_level(n, layers):
    plan = K.merkle_plan(n, layers, H100_SMS)
    width, done = n, 0
    for step in plan:
        if step[0] == "level":
            _, parents, g, threads = step
            assert parents == width // 2 and g in K.GROUPS
            assert threads % 32 == 0 and 32 <= threads <= 128
            width, done = parents, done + 1
        else:
            _, w, tail_layers, subtrees, threads = step
            assert step is plan[-1] and w == width
            assert tail_layers <= K.TAIL_MAX_LAYERS
            assert subtrees == width >> tail_layers == n >> layers
            assert (width // 2) // subtrees <= K.TAIL_PARENTS
            assert threads == 16 << (tail_layers - 1) <= 1024
            done += tail_layers
    assert done == layers


def test_merkle_plan_spreads_the_prove_tree():
    """No level of a 2^15-leaf tree to a cap of 16 runs with one thread per
    permutation on fewer than all SMs: each level either fills every SM
    with FILL_PER_SM threads or has 12 threads per state and a block per
    16 SMs at most."""
    for step in K.merkle_plan(1 << 15, 11, H100_SMS):
        if step[0] == "level":
            _, parents, g, threads = step
            total = parents * K.SPAN[g]
            blocks = -(-total // threads)
            assert total >= K.FILL_PER_SM * H100_SMS or g == 12
            assert blocks >= min(H100_SMS, total // 32)
        else:
            assert step[3] == 16 and step[4] == 128   # 16 blocks, G = 12


def test_group_and_block_choice():
    assert K.group_for(1 << 15, H100_SMS) == 1          # the wires' sponge
    assert K.group_for(1 << 14, H100_SMS) == 2
    assert K.group_for(1 << 13, H100_SMS) == 4
    assert K.group_for(1 << 10, H100_SMS) == 12
    assert K.block_for(1 << 15, H100_SMS) == 128
    assert K.block_for(4096, H100_SMS) == 32
    assert K.block_for(16, H100_SMS) == 32


def test_group_sweep_needs_the_card():
    import torch

    with pytest.raises(ValueError, match="needs the card"):
        runner.run_groups(torch.device("cpu"))


def test_sass_per_permutation_reader():
    """Three round loops of 100+ instructions (4, 22, 4 trips) and a
    four-instruction copy loop: each round loop counts times its trips, the
    rest once."""
    code, addr = [], 0

    def emit(insn):
        nonlocal addr
        code.append((addr, insn))
        addr += 16

    emit("LDC R1, c[0x0][0x28]")
    start = addr
    for _ in range(3):
        emit("IADD3 R2, R2, 0x1, RZ")
    emit(f"@P0 BRA 0x{start:x}")
    for body in (120, 110, 120):
        start = addr
        for i in range(body - 1):
            emit("IMAD.WIDE.U32 R4, R2, 0x11, R4" if i % 2 else
                 "SHFL.IDX PT, R5, R4, R3, 0x1f")
        emit(f"@P1 BRA 0x{start:x}")
    emit("EXIT")
    rec = runner.per_permutation(code)
    assert rec["round_loops"] == [120, 110, 120]
    assert rec["instructions"] == len(code) + 3 * 120 + 21 * 110 + 3 * 120
    assert sum(rec["split"].values()) == rec["instructions"]
    assert rec["split"]["IMAD.WIDE"] == 59 * 4 + 54 * 22 + 59 * 4
    assert rec["split"]["SHFL"] == 60 * 4 + 55 * 22 + 60 * 4
    assert runner.per_permutation(code[:10]) is None


# -- the measurement hooks ---------------------------------------------------


def test_call_recorder():
    """``ops.record`` appends a wrapper's call only while ``ops.calls`` is a
    list."""
    from plonky2_goldibear_torch import ops

    ops.record("ntt", 1, 32768, 0)
    assert ops.calls is None
    ops.calls = []
    try:
        ops.record("ntt", 1, 32768, 0)
        ops.record("merkle_levels", 2048, 7)
        assert ops.calls == [("ntt", 1, 32768, 0), ("merkle_levels", 2048, 7)]
    finally:
        ops.calls = None


def test_kernel_times_reads_the_report_shapes():
    from plonky2_goldibear_torch import kernel_times

    report = {"checks": {
        "leaf_sponge_2^15x135": {"ms": 1.0},
        "prove_leaf_sponge_128_32_4": {"call": ["leaf_sponge", 128, 32, 4]},
        "prove_merkle_levels_2048_7": {"call": ["merkle_levels", 2048, 7]},
        "prove_ntt_1_128_0": {"call": ["ntt", 1, 128, 0]},
        "prove_permute_64": {"call": ["permute", 64]}}}
    assert kernel_times.shapes_of(report) == [
        ("leaf_sponge", 128, 32, 4), ("merkle_levels", 2048, 7),
        ("ntt", 1, 128, 0)] + list(kernel_times.EXTRA)
    assert kernel_times.main(["--root", ".", "--report", "unused"]) == 2
