"""The device transcript's CUDA source (``csrc/transcript.cu``) on the CPU.

The device code, compiled by the host C++ compiler against a stub of the
CUDA runtime (the launches stripped; a block's threads as threads meeting
at a barrier for its shuffles and ``__syncthreads``; atomics under a
lock; the one inline PTX instruction as plain C++), runs:

- ``flush_kernel`` for both hashers on schedules that take each branch
  (full chunks and a partial one, a final observe that refills the
  outputs, squeezes with nothing absorbed, a pure absorb with a leftover,
  pieces of every length): each result equals ``transcript_flush_plain``;
- ``grind_kernel`` for both hashers with its blocks run one after another
  (the first claims every chunk up to its hit, the others stop at their
  first claim): the witness and flag equal ``pow_grind_plain``'s and the
  counters say every chunk up to the witness was tested.  An exhausted
  search (2^32 candidates) is left to the card's tests.

They skip where no ``g++`` is found.  Tolerance zero: exact field
arithmetic.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from plonky2_goldibear_torch.field import bb, gl
from plonky2_goldibear_torch.hash import _poseidon_gl_constants as CGL
from plonky2_goldibear_torch.ops import _build
from plonky2_goldibear_torch.ops import poseidon2_bb as K2
from plonky2_goldibear_torch.ops import transcript as T

torch.set_num_threads(1)

_STUB = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#include <mutex>
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
extern dim3_ blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, unsigned long n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
extern std::barrier<>* g_bar;
extern uint64_t g_slot[1024];
extern std::mutex g_atomic;
template <class T> T shfl_at(T v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_slot[threadIdx.x] = u;
  g_bar->arrive_and_wait();
  uint64_t r = g_slot[src];
  g_bar->arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src, int width) {
  return shfl_at(v, threadIdx.x / width * width + src);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int d, int width) {
  return shfl_at(v, threadIdx.x ^ d);
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint64_t)a * b >> 32;
}
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return (unsigned __int128)a * b >> 64;
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  std::lock_guard<std::mutex> hold(g_atomic);
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  std::lock_guard<std::mutex> hold(g_atomic);
  const unsigned long long old = *p;
  if (v > old) *p = v;
  return old;
}
inline void __threadfence() {}
inline void __syncthreads() { g_bar->arrive_and_wait(); }
template <class A, class B> int cudaMemcpyToSymbol(A& a, B b, unsigned long n) {
  std::memcpy((void*)&a, (const void*)b, n);
  return 0;
}
"""

# flush <g|b> total n_out n pieces len... ; state, out_buf, pieces
# grind <g|b> L k blocks ; state, leftover
_HARNESS = r"""
#include "transcript_host.cpp"
#include <cstdio>
#include <thread>
#include <vector>
thread_local dim3_ threadIdx{0, 0, 0};
dim3_ blockIdx{0, 0, 0}, blockDim{1, 1, 1}, gridDim{1, 1, 1};
std::barrier<>* g_bar;
uint64_t g_slot[1024];
std::mutex g_atomic;
template <class T> std::vector<T> read(long long n) {
  std::vector<T> v(n);
  for (auto& x : v) {
    unsigned long long u;
    if (scanf("%llu", &u) != 1) exit(1);
    x = T(u);
  }
  return v;
}
template <class T> void write(const T* v, long long n) {
  for (long long i = 0; i < n; ++i) printf("%llu ", (unsigned long long)v[i]);
  printf("\n");
}
template <class H> void flush(int W) {
  using T = typename H::T;
  long long total; int n_out, n, count;
  if (scanf("%lld %d %d %d", &total, &n_out, &n, &count) != 4) exit(1);
  std::vector<long long> lens(count);
  for (auto& l : lens) if (scanf("%lld", &l) != 1) exit(1);
  auto state = read<T>(W), out_buf = read<T>(8);
  std::vector<std::vector<T>> pieces;
  Pieces<T> p{};
  long long end = 0;
  for (int k = 0; k < count; ++k) {
    pieces.push_back(read<T>(lens[k]));
    end += lens[k];
    p.ptr[k] = pieces.back().data();
    p.end[k] = end;
  }
  p.count = count;
  std::vector<T> dst(W + 8 + (n ? n : total % 8));
  std::barrier<> bar(FLUSH_THREADS);
  g_bar = &bar;
  blockDim.x = FLUSH_THREADS;
  std::vector<std::thread> th;
  for (int t = 0; t < FLUSH_THREADS; ++t) th.emplace_back([&, t] {
    threadIdx.x = t;
    flush_kernel<H>(state.data(), out_buf.data(), p, total, n_out, n,
                    dst.data());
  });
  for (auto& x : th) x.join();
  write(dst.data(), dst.size());
}
template <class Fd, class One, int SMEM> void grind(int W) {
  using T = typename Fd::T;
  int L, k, blocks;
  if (scanf("%d %d %d", &L, &k, &blocks) != 3) exit(1);
  auto state = read<T>(W), left = read<T>(L);
  unsigned long long scratch[4] = {0, 0, 0, 0};
  T out[2] = {7, 7};
  gridDim.x = blocks;
  blockDim.x = GRIND_THREADS;
  for (int b = 0; b < blocks; ++b) {      // one block after another
    blockIdx.x = b;
    std::barrier<> bar(GRIND_THREADS);
    g_bar = &bar;
    std::vector<std::thread> th;
    for (int t = 0; t < GRIND_THREADS; ++t) th.emplace_back([&, t] {
      threadIdx.x = t;
      grind_kernel<Fd, One, SMEM>(state.data(), L ? left.data() : nullptr, L,
                                  k, scratch, out);
    });
    for (auto& x : th) x.join();
  }
  write(out, 2);
  write(scratch, 4);
}
int main() {
  std::vector<unsigned long long> rc(poseidon_gl::N_ROUNDS * 12);
  for (auto& x : rc) if (scanf("%llu", &x) != 1) return 1;
  std::vector<uint64_t> rc64(rc.begin(), rc.end());
  poseidon_gl::set_constants(rc64.data());
  std::vector<uint32_t> t[6];
  const int sizes[6] = {8 * 16, 13, 1, 16, 16 * 14, 13};
  for (int i = 0; i < 6; ++i) t[i] = read<uint32_t>(sizes[i]);
  poseidon2_bb::set_constants(t[0].data(), t[1].data(), t[2].data(),
                              t[3].data(), t[4].data(), t[5].data());
  char what[8], field[4];
  while (scanf("%7s %3s", what, field) == 2) {
    const bool g = field[0] == 'g';
    if (what[0] == 'f') {
      if (g) flush<GlGroup>(12); else flush<BbGroup>(16);
    } else {
      if (g) grind<GlField, GlOne, poseidon_gl::RC2_WORDS / 4>(12);
      else grind<BbField, BbOne, 1>(16);
    }
    fflush(stdout);
  }
}
"""


def _read(name: str) -> str:
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    """The harness built from the sources as they are."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the device code for the host")
    d = tmp_path_factory.mktemp("transcript_host")
    header, n = re.subn(
        r'asm\("mad\.lo\.u32 %0, %1, %2, %0;" : "\+r"\(acc\) : "r"\(x\), '
        r'"n"\(C\)\);', "acc += x * C;", _read("poseidon_gl.cuh"))
    assert n == 1, "the inline PTX of csrc/poseidon_gl.cuh changed"
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "poseidon_gl.cuh").write_text(header)
    (d / "transcript_host.cpp").write_text(
        re.sub(r"<<<.*?>>>", "", _read("transcript.cu"), flags=re.S))
    (d / "harness.cpp").write_text(_HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-pthread",
                    "-I", str(d), "-I", _build.CSRC,
                    str(d / "harness.cpp"), "-o", exe],
                   check=True, capture_output=True, timeout=300)
    return exe


def _constants() -> str:
    words = list(CGL.ALL_ROUND_CONSTANTS)
    for table in K2.constant_tables():
        words += [int(v) for v in table]
    return " ".join(map(str, words))


def _run(exe, requests) -> list:
    text = _constants() + "\n" + "\n".join(requests) + "\n"
    out = subprocess.run([exe], input=text, capture_output=True, text=True,
                         check=True, timeout=300).stdout.split("\n")
    return [[int(x) for x in line.split()] for line in out if line.strip()]


FIELDS = {"g": (gl, 12), "b": (bb, 16)}
# (pending lengths, outputs left, challenges)
FLUSH_CASES = [((3, 10), 0, 5), ((8,), 0, 2), ((16,), 0, 11), ((), 5, 3),
               ((), 2, 7), ((16, 3), 0, 0), ((24,), 0, 0), ((1,) * 8, 0, 4),
               ((21, 2), 0, 9)]


def _vals(F, n, rng):
    return [int(x) for x in rng.integers(0, F.P, size=n, dtype=np.uint64)]


def _words(F, vals):
    """The kernel's words of canonical values: Montgomery forms for
    BabyBear."""
    return [int(v) for v in F.from_ints(vals).tolist()] if F is bb else vals


def _canonical(F, words):
    return [int(v) for v in F.to_ints(
        torch.tensor(words, dtype=torch.int64).to(F.DTYPE) if F is bb
        else F.from_ints(words))]


@pytest.mark.parametrize("field", list(FIELDS))
def test_flush_kernel_matches_plain(host_binary, field):
    F, W = FIELDS[field]
    rng = np.random.default_rng(4)
    requests, want = [], []
    for lens, n_out, n in FLUSH_CASES:
        state, out_buf = _vals(F, W, rng), _vals(F, 8, rng)
        pieces = [_vals(F, k, rng) for k in lens]
        requests.append(" ".join(map(str, [
            "flush", field, sum(lens), n_out, n, len(lens), *lens,
            *_words(F, state + out_buf + [v for p in pieces for v in p])])))
        want.append([int(v) for v in F.to_ints(T.transcript_flush_plain(
            F.from_ints(state), F.from_ints(out_buf),
            [F.from_ints(p) for p in pieces], n_out, n))])
    got = _run(host_binary, requests)
    for case, g, w in zip(FLUSH_CASES, got, want):
        assert _canonical(F, g) == w, case


@pytest.mark.parametrize("field", list(FIELDS))
def test_grind_kernel_matches_plain(host_binary, field):
    F, W = FIELDS[field]
    rng = np.random.default_rng(6)
    cases = [(0, 6), (3, 9), (7, 2)]          # (L, PoW bits)
    requests, inputs = [], []
    for L, bits in cases:
        state, left = _vals(F, W, rng), _vals(F, L, rng)
        k = F.SPEC.bits - bits
        requests.append(" ".join(map(str, ["grind", field, L, k, 3,
                                           *_words(F, state + left)])))
        inputs.append((state, left, k))
    got = _run(host_binary, requests)
    chunk = T.GRIND_CHUNK
    for (state, left, k), out, scratch in zip(inputs, got[0::2],
                                              got[1::2]):
        ref = T.pow_grind_plain(F.from_ints(state),
                                F.from_ints(left) if left else None, k,
                                batch=64)
        w, found = _canonical(F, out)
        assert [w, found] == [int(v) for v in F.to_ints(ref)]
        assert found == 1
        claimed, best_not, done, tested = scratch
        assert best_not == (1 << 64) - 1 - w
        assert done == 3 and tested * chunk > w
        assert claimed == tested + 3           # each block's last claim
