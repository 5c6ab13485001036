// Batched radix-2 DIT NTT pass, natural order in and out, templated on the
// field: the one schedule behind ntt_gl.cu (Goldilocks, u64) and ntt_bb.cu
// (BabyBear Montgomery form, u32).
//
// Bound on the H100: memory.  A butterfly is one field multiply per two
// elements, far below the card's integer rate for the bytes it moves, so
// the cost is the passes over device memory.  Design: a block holds a tile
// of 2^LOG_TILE elements in shared memory (32 KB: 2^12 u64 or 2^13 u32)
// and runs as many stages as the tile spans before writing back; an NTT of
// length 2^n takes ceil(n / LOG_TILE) passes.  Pass p owns stages
// [s0, s1): with the element index written as j + (k << s0) + (h << s1),
// j < 2^s0, every butterfly of those stages pairs two elements of the same
// (j, h) column, so a tile of 2^(LOG_TILE - (s1 - s0)) consecutive columns
// is independent of all others.  The input is already in bit-reversed
// order (ntt_cluster.cuh's bitrev_kernel writes it, the LDE zero prefix's
// copies included); stages below s_begin, which only replicate each
// coefficient over its 2^r block, are skipped.  A stage value may stay
// unreduced where the field allows it (ntt_cluster.cuh); the last pass
// stores canonical values.
//
// Field must provide: typename T; static __device__ T mul(T, T), add, sub,
// canon.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace ntt {

constexpr int MAX_THREADS = 512;

// tw[(1 << s) - 1 + i] = w_{2^(s+1)}^i for every stage s < n_log, i < 2^s.
template <typename Field, int LOG_TILE>
__global__ void pass_kernel(const typename Field::T* __restrict__ in,
                            typename Field::T* out,
                            const typename Field::T* __restrict__ tw,
                            int n_log, int s0, int s1, int s_begin) {
  using T = typename Field::T;
  __shared__ T buf[1 << LOG_TILE];
  const int tile_log = n_log < LOG_TILE ? n_log : LOG_TILE;
  const int tile = 1 << tile_log;
  const int cols_log = tile_log - (s1 - s0);  // consecutive j per tile
  const int64_t n = int64_t(1) << n_log;
  const int64_t tiles_per_poly = n >> tile_log;
  const int64_t poly = blockIdx.x / tiles_per_poly;
  const int64_t u = blockIdx.x % tiles_per_poly;
  const int64_t jblocks = int64_t(1) << (s0 - cols_log);
  const int64_t jbase = (u % jblocks) << cols_log;
  const int64_t hbase = (u / jblocks) << s1;
  const int cmask = (1 << cols_log) - 1;
  const T* src = in + poly * n;
  T* dst = out + poly * n;

  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int64_t g =
        jbase + (e & cmask) + (int64_t(e >> cols_log) << s0) + hbase;
    buf[e] = src[g];
  }
  __syncthreads();

  for (int s = s_begin; s < s1; ++s) {
    const int ls = s - s0;
    const int half = 1 << ls;
    const T* row = tw + ((int64_t(1) << s) - 1);
    for (int bf = threadIdx.x; bf < (tile >> 1); bf += blockDim.x) {
      const int jj = bf & cmask;
      const int kb = bf >> cols_log;
      const int kr = kb & (half - 1);
      const int klo = ((kb >> ls) << (ls + 1)) + kr;
      const int e0 = (klo << cols_log) + jj;
      const int e1 = e0 + (half << cols_log);
      const T w = row[jbase + jj + (int64_t(kr) << s0)];
      const T a = buf[e0];
      const T b = Field::mul(buf[e1], w);
      buf[e0] = Field::add(a, b);
      buf[e1] = Field::sub(a, b);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int64_t g =
        jbase + (e & cmask) + (int64_t(e >> cols_log) << s0) + hbase;
    dst[g] = s1 == n_log ? Field::canon(buf[e]) : buf[e];
  }
}

template <typename Field, int LOG_TILE>
int launch_pass(const typename Field::T* in, typename Field::T* out,
                const typename Field::T* tw, long long batch, int n_log,
                int s0, int s1, int s_begin, void* stream) {
  const int tile_log = n_log < LOG_TILE ? n_log : LOG_TILE;
  const long long blocks = batch << (n_log - tile_log);
  int threads = (1 << tile_log) / 2;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  if (threads < 1) threads = 1;
  pass_kernel<Field, LOG_TILE>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          in, out, tw, n_log, s0, s1, s_begin);
  return (int)cudaGetLastError();
}

}  // namespace ntt
