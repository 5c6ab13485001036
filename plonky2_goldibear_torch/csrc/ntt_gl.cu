// Batched radix-2 DIT Goldilocks NTT, natural order in and out.
//
// Replaces the TPU kernel ops/ntt.py:_fft_fused (and _fft_four_step above
// 2^16) of plonky2_goldibear_tpu.
//
// Bound on the H100: memory.  A butterfly is one field multiply (a few
// dozen integer ops) per two elements, far below the card's integer rate
// for the bytes it moves, so the cost is the passes over device memory.
// Design: a block holds a tile of 2^12 u64 (32 KB) in shared memory and
// runs as many stages as the tile spans before writing back; an NTT of
// length 2^n takes ceil(n / 12) passes (one for the prover's 2^12 iFFTs,
// two for its 2^15 LDEs).  Pass p owns stages [s0, s1): with the element
// index written as j + (k << s0) + (h << s1), j < 2^s0, every butterfly of
// those stages pairs two elements of the same (j, h) column, so a tile of
// 2^(12 - (s1 - s0)) consecutive columns is independent of all others.
// The first pass folds the bit-reversal permutation and the LDE zero-prefix
// skip into its load: position g reads x[rev(g >> r)], and stages below r
// (which only replicate each coefficient over its 2^r block) are skipped.
// Every stage value stays canonical (< p), so the lazy-subtract double wrap
// that broke the TPU kernel in round 3 cannot occur.
#include <cstdint>
#include <cuda_runtime.h>

#include "gl.cuh"

namespace {

constexpr int LOG_TILE = 12;
constexpr int TILE = 1 << LOG_TILE;
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ uint64_t bitrev(uint64_t x, int bits) {
  return bits == 0 ? 0 : (__brevll(x) >> (64 - bits));
}

// tw[(1 << s) - 1 + i] = w_{2^(s+1)}^i for every stage s < n_log, i < 2^s.
__global__ void ntt_pass_kernel(const uint64_t* __restrict__ in,
                                uint64_t* out,
                                const uint64_t* __restrict__ tw, int n_log,
                                int s0, int s1, int s_begin, int load_bitrev,
                                int zero_log) {
  __shared__ uint64_t buf[TILE];
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
  const uint64_t* src = in + poly * n;
  uint64_t* dst = out + poly * n;

  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int64_t g =
        jbase + (e & cmask) + (int64_t(e >> cols_log) << s0) + hbase;
    buf[e] = load_bitrev
                 ? src[bitrev(uint64_t(g) >> zero_log, n_log - zero_log)]
                 : src[g];
  }
  __syncthreads();

  for (int s = s_begin; s < s1; ++s) {
    const int ls = s - s0;
    const int half = 1 << ls;
    const uint64_t* row = tw + ((int64_t(1) << s) - 1);
    for (int bf = threadIdx.x; bf < (tile >> 1); bf += blockDim.x) {
      const int jj = bf & cmask;
      const int kb = bf >> cols_log;
      const int kr = kb & (half - 1);
      const int klo = ((kb >> ls) << (ls + 1)) + kr;
      const int e0 = (klo << cols_log) + jj;
      const int e1 = e0 + (half << cols_log);
      const uint64_t w = row[jbase + jj + (int64_t(kr) << s0)];
      const uint64_t a = buf[e0];
      const uint64_t b = gl::mul(buf[e1], w);
      buf[e0] = gl::add(a, b);
      buf[e1] = gl::sub(a, b);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int64_t g =
        jbase + (e & cmask) + (int64_t(e >> cols_log) << s0) + hbase;
    dst[g] = buf[e];
  }
}

}  // namespace

extern "C" int ntt_gl_pass(const uint64_t* in, uint64_t* out,
                           const uint64_t* tw, long long batch, int n_log,
                           int s0, int s1, int s_begin, int load_bitrev,
                           int zero_log, void* stream) {
  const int tile_log = n_log < LOG_TILE ? n_log : LOG_TILE;
  const long long blocks = batch << (n_log - tile_log);
  int threads = (1 << tile_log) / 2;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  if (threads < 1) threads = 1;
  ntt_pass_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      in, out, tw, n_log, s0, s1, s_begin, load_bitrev, zero_log);
  return (int)cudaGetLastError();
}
