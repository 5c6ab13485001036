"""The BabyBear cluster NTT (``csrc/ntt_bb.cu``, ``ops/ntt_bb.py``) on the
CPU.

- ``fft_by_cluster`` replays the kernel's schedule (the strided load into
  each block's swizzled compact buffer, the stages on a block's own
  positions, the exchange between the blocks, the stages across them) in
  plain torch, at every cluster size the kernel takes at the row's length;
  it equals ``fft_plain`` and the JAX package's ``_fft_fused`` run in
  interpret mode.
- The device code itself, compiled by the host C++ compiler against a stub
  of the CUDA runtime and of cooperative groups (a cluster's blocks as
  threads, ``cluster.sync()`` and ``__syncthreads()`` as barriers,
  ``map_shared_rank`` as a pointer into another block's buffer), equals
  ``fft_plain``, and so do the bit-reversal and pass kernels of rows above
  2^15 (one block at a time); it skips where no ``g++`` is found.
- ``plan`` gives every NTT call of a BabyBear prove one launch that
  spreads over the card, and the source's limits equal the wrapper's.

Tolerance zero throughout: exact field arithmetic.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.field import bb as jbb

from plonky2_goldibear_torch.field import bb as tbb
from plonky2_goldibear_torch.ops import _build
from plonky2_goldibear_torch.ops import ntt as tntt_gl
from plonky2_goldibear_torch.ops import ntt_bb as K

torch.set_num_threads(1)
P = tbb.P
SOURCE = os.path.join(_build.CSRC, "ntt_bb.cu")
H100_SMS = 132


def _source(path: str = SOURCE) -> str:
    """The source and the cluster header it instantiates."""
    with open(path) as f, open(os.path.join(_build.CSRC,
                                            "ntt_cluster.cuh")) as g:
        return f.read() + g.read()


def _rows(seed, batch, n_log, r):
    x = np.random.default_rng(seed).integers(0, P, size=(batch, 1 << n_log),
                                             dtype=np.uint64)
    x[:, (1 << n_log) >> r:] = 0
    return x


def _mont(t):
    return t.numpy().astype(np.uint32)


# -- the schedule in plain torch ------------------------------------------


@pytest.mark.parametrize("batch", [1, 4, 6])
@pytest.mark.parametrize("n_log,r", [(8, 0), (8, 3), (10, 0), (10, 3)])
def test_cluster_schedule_matches_plain_and_pallas(n_log, r, batch):
    import plonky2_goldibear_tpu.ops.ntt_bb as JNTT
    import plonky2_goldibear_tpu.ops.poseidon_gl as JK

    x = _rows(80 + n_log + r + batch, batch, n_log, r)
    old = JK._INTERPRET
    JK._INTERPRET = True
    try:
        ref = np.asarray(JNTT.fft(jbb.from_ints(x), zero_prefix_log=r))
    finally:
        JK._INTERPRET = old
    t = tbb.from_ints(x)
    np.testing.assert_array_equal(_mont(K.fft_plain(t, r)), ref)
    for c_log in [c for c in range(K.MAX_CLUSTER_LOG + 1) if c == 0 or (
            n_log - c > r and n_log - 2 * c >= 2)]:
        np.testing.assert_array_equal(_mont(K.fft_by_cluster(t, r, c_log)),
                                      ref, err_msg=f"c_log {c_log}")


# -- the device code on the host ------------------------------------------

_STUB = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) uint4 { unsigned x, y, z, w; };
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class F, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t*, F, A...) { return 0; }
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
template <class F>
int cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t*) {
  *n = 1;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) { r = (r << 1) | (x & 1); x >>= 1; }
  return r;
}
inline unsigned long long __brevll(unsigned long long x) {
  return ((unsigned long long)__brev(unsigned(x)) << 32) | __brev(unsigned(x >> 32));
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned long long)a * b >> 32;
}
inline unsigned long long __umul64hi(unsigned long long a,
                                     unsigned long long b) {
  return (unsigned __int128)a * b >> 64;
}
extern thread_local std::barrier<>* g_block_bar;
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
"""

_CG_STUB = r"""
#pragma once
#include "cuda_runtime.h"
struct ClusterEmu { std::barrier<>* bar; void** smem; unsigned rank; };
extern thread_local ClusterEmu g_cluster;
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return g_cluster.rank; }
  void sync() { g_cluster.bar->arrive_and_wait(); }
  template <class T> T* map_shared_rank(T* p, unsigned rank) {
    char* mine = (char*)g_cluster.smem[g_cluster.rank];
    return (T*)((char*)g_cluster.smem[rank] + ((char*)p - mine));
  }
};
inline cluster_group this_cluster() { return {}; }
}
"""

# every block of one cluster at once, clusters one after another; or, with
# "passes", the bit-reversal launch and the passes, block after block.
# FIELD is the source's field struct (BB or GL), W its word.
_HARNESS = r"""
#include "cuda_runtime.h"
#include "ntt_host.cpp"
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local std::barrier<>* g_block_bar;
thread_local ClusterEmu g_cluster;
uint4 ntt_smem[1];
template <class F> void run_blocks(long long blocks, int threads, F body) {
  blockDim = dim3(threads);
  gridDim = dim3(unsigned(blocks));
  for (long long blk = 0; blk < blocks; ++blk) {
    std::barrier<> bar(threads);
    std::vector<std::thread> th;
    for (int t = 0; t < threads; ++t)
      th.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(unsigned(blk));
        g_block_bar = &bar;
        body();
      });
    for (auto& x : th) x.join();
  }
}
using W = FIELD::T;
constexpr int LOG_TILE = FIELD::LOG_TILE;
bool read(std::vector<W>& v) {
  for (auto& x : v) {
    unsigned long long y;
    if (scanf("%llu", &y) != 1) return false;
    x = W(y);
  }
  return true;
}
void write(const std::vector<W>& v) {
  for (auto x : v) printf("%llu ", (unsigned long long)x);
  printf("\n");
}
int passes(char** argv) {
  const int n_log = atoi(argv[2]), r = atoi(argv[3]);
  const long long batch = atoll(argv[4]), n = 1LL << n_log;
  std::vector<W> tw(n - 1), in(batch * n), out(batch * n, 0);
  if (!read(tw) || !read(in)) return 1;
  run_blocks(batch << (n_log - r - 10), 256, [&] {
    ntt_cluster::bitrev_kernel<W>(in.data(), out.data(), n_log, r);
  });
  for (int s0 = 0; s0 < n_log; s0 += LOG_TILE) {
    const int s1 = s0 + LOG_TILE < n_log ? s0 + LOG_TILE : n_log;
    const int tile_log = n_log < LOG_TILE ? n_log : LOG_TILE;
    int threads = (1 << tile_log) / 2;
    if (threads > ntt::MAX_THREADS) threads = ntt::MAX_THREADS;
    run_blocks(batch << (n_log - tile_log), threads, [&] {
      ntt::pass_kernel<FIELD, LOG_TILE>(out.data(), out.data(), tw.data(),
                                        n_log, s0, s1, s0 > r ? s0 : r);
    });
  }
  write(out);
  return 0;
}
int main(int argc, char** argv) {
  if (argv[1][0] == 'p') return passes(argv);
  const int n_log = atoi(argv[1]), c_log = atoi(argv[2]), r = atoi(argv[3]);
  const long long batch = atoll(argv[4]);
  const int clusters = atoi(argv[5]), threads = atoi(argv[6]);
  const long long n = 1LL << n_log;
  const int C = 1 << c_log;
  std::vector<W> tw(n - 1), in(batch * n), out(batch * n, 0);
  if (!read(tw) || !read(in)) return 1;
  gridDim = dim3(clusters * C);
  blockDim = dim3(threads);
  for (int cid = 0; cid < clusters; ++cid) {
    std::barrier<> cbar(C * threads);
    std::vector<std::unique_ptr<std::barrier<>>> bbar;
    std::vector<std::vector<W>> smem;
    std::vector<W*> ptrs;
    for (int b = 0; b < C; ++b) {
      bbar.emplace_back(new std::barrier<>(threads));
      smem.emplace_back(ntt_cluster::smem_words(n_log, c_log, r));
    }
    for (auto& v : smem) ptrs.push_back(v.data());
    std::vector<std::thread> th;
    for (int b = 0; b < C; ++b)
      for (int t = 0; t < threads; ++t)
        th.emplace_back([&, b, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(cid * C + b);
          g_block_bar = bbar[b].get();
          g_cluster = ClusterEmu{&cbar, (void**)ptrs.data(), unsigned(b)};
          ntt_cluster::ntt_cluster_body<FIELD>(ptrs[b], in.data(), out.data(),
                                              tw.data(), batch, n_log, c_log,
                                              r);
        });
    for (auto& x : th) x.join();
  }
  write(out);
}
"""


def _for_host(text: str) -> str:
    """CUDA source as host C++: launches dropped, dynamic shared memory an
    ordinary array."""
    return re.sub(r"<<<.*?>>>", "", text, flags=re.S).replace(
        "extern __shared__", "extern")


def build_harness(d, lib: str, field: str) -> str:
    """The harness of ``csrc/<lib>.cu`` (its field struct ``field``), every
    header of ``csrc/`` beside it, built in directory d; its path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the device code for the host")
    for name in os.listdir(_build.CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(_build.CSRC, name)) as f:
                (d / name).write_text(_for_host(f.read()))
    with open(os.path.join(_build.CSRC, lib + ".cu")) as f:
        (d / "ntt_host.cpp").write_text(_for_host(f.read()))
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "cooperative_groups.h").write_text(_CG_STUB)
    (d / "harness.cpp").write_text(_HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-pthread",
                    f"-DFIELD={field}", "-I", str(d),
                    str(d / "harness.cpp"), "-o", exe],
                   check=True, capture_output=True, timeout=300)
    return exe


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    """The harness built from the source as it is."""
    return build_harness(tmp_path_factory.mktemp("ntt_bb_host"), "ntt_bb",
                         "BB")


# (n_log, r, c_log, batch, clusters, threads): every cluster size, the
# zero prefix, rows walked by fewer clusters than rows, more positions
# than threads
HOST_CASES = [(1, 0, 0, 3, 2, 32), (2, 1, 0, 2, 1, 32), (6, 0, 0, 4, 4, 32), (8, 0, 0, 3, 2, 32), (8, 3, 2, 4, 1, 32),
              (9, 3, 1, 2, 2, 64), (10, 0, 3, 6, 4, 32),
              (10, 3, 4, 2, 1, 32), (10, 0, 4, 3, 2, 32)]


@pytest.mark.parametrize("n_log,r,c_log,batch,clusters,threads", HOST_CASES)
def test_device_ntt_on_host(host_binary, n_log, r, c_log, batch, clusters,
                            threads):
    x = tbb.from_ints(_rows(n_log * 10 + c_log, batch, n_log, r))
    tw = tntt_gl.twiddles(n_log, "cpu", tbb)
    text = " ".join(map(str, _mont(tw))) + "\n" + \
        " ".join(map(str, _mont(x).ravel()))
    out = subprocess.run([host_binary] + [str(v) for v in (
        n_log, c_log, r, batch, clusters, threads)], input=text,
        capture_output=True, text=True, check=True, timeout=120).stdout
    got = np.array(out.split(), dtype=np.uint32).reshape(batch, 1 << n_log)
    np.testing.assert_array_equal(got, _mont(K.fft_plain(x, r)))


@pytest.mark.parametrize("n_log,r,batch", [(14, 0, 2), (14, 3, 1), (12, 2, 3)])
def test_device_passes_on_host(host_binary, n_log, r, batch):
    """Rows above 2^15 take the bit-reversal launch and then the passes of
    ntt.cuh (tiles of 2^13: two passes at 2^14)."""
    x = tbb.from_ints(_rows(n_log + r, batch, n_log, r))
    tw = tntt_gl.twiddles(n_log, "cpu", tbb)
    text = " ".join(map(str, _mont(tw))) + "\n" + \
        " ".join(map(str, _mont(x).ravel()))
    out = subprocess.run([host_binary, "passes", str(n_log), str(r),
                          str(batch)], input=text, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    got = np.array(out.split(), dtype=np.uint32).reshape(batch, 1 << n_log)
    np.testing.assert_array_equal(got, _mont(K.fft_plain(x, r)))


# -- the launch plan -------------------------------------------------------


def _int(name: str, path: str = SOURCE) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _source(path))
    assert m, name
    return int(m.group(1))


def test_cuda_source_limits():
    assert _int("LOG_TILE") == K.LOG_TILE
    assert _int("CLUSTER_MAX_LOG") == K.CLUSTER_MAX_LOG
    assert _int("MAX_CLUSTER_LOG") == K.MAX_CLUSTER_LOG
    assert _int("MAX_THREADS") == K.MAX_THREADS
    assert _int("MAX_SMEM") == K.MAX_SMEM
    assert _int("MAX_XCHG") == K.MAX_XCHG
    assert _int("MAX_R") == K.MAX_R


# every NTT call of a 2^12 BabyBear prove (167 wires, 6 challenges, bb4
# FRI of arity 2^3), and the single rows the prover sent before batching
PROVE_CALLS = [(167, 12, 0), (167, 15, 3), (36, 12, 0), (36, 15, 3),
               (6, 15, 0), (48, 15, 3), (4, 15, 0), (4, 12, 0), (4, 9, 0),
               (4, 6, 0), (1, 15, 0), (1, 12, 0)]


@pytest.mark.parametrize("batch,n_log,r", PROVE_CALLS)
def test_plan_is_one_launch_that_spreads(batch, n_log, r):
    p = K.plan(batch, n_log, H100_SMS, r)
    assert p.route == "cluster"
    assert p.c_log in K.cluster_logs(n_log, r)
    assert n_log - p.c_log > r or p.c_log == 0
    assert p.smem == K.smem_bytes(n_log, p.c_log, r) <= K.MAX_SMEM
    assert p.threads % 32 == 0 and 32 <= p.threads <= K.MAX_THREADS
    assert 1 <= p.clusters <= batch
    blocks = p.clusters << p.c_log
    # a few rows take the largest cluster their length allows; a batch
    # that fills the card gives every SM a block
    assert blocks >= min(H100_SMS, batch << K.cluster_logs(n_log, r)[-1])
    if n_log == 15 and batch <= 6:
        assert p.c_log == K.MAX_CLUSTER_LOG        # 16 SMs a row


def test_plan_routes():
    assert K.plan(1, 25, H100_SMS).route == "passes"
    assert K.plan(1, 16, H100_SMS).route == "passes"
    # a 2^15 row does not fit one block's shared memory with its twiddles
    assert 0 not in K.cluster_logs(15)
    assert K.cluster_logs(6) == [0]
    p = K.plan(167, 15, H100_SMS, 3)
    assert K.blocks_per_sm(15, p.c_log, 3) * p.threads >= K.FILL_THREADS


def test_bb_fft_refuses_a_zero_prefix_beyond_the_row():
    with pytest.raises(ValueError):
        K.fft(tbb.zeros((2, 8)), 4)
