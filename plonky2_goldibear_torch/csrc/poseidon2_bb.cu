// Poseidon2 width-16 permutation over BabyBear and the two hashing kernels
// built on it: the overwrite-mode leaf sponge and the Merkle levels.  The
// reference's round schedule (gates/poseidon2_babybear.rs:700-995): the
// initial external layer, 4 full rounds, 13 partial rounds, 4 full rounds,
// x^7 S-box; bit-exact with hash/poseidon2_bb.py:permute_host.  Values are
// Montgomery forms (bb.cuh), as are the constants.
//
// Replaces the TPU kernel ops/poseidon2_bb.py:permute_cols of
// plonky2_goldibear_tpu, which the JAX package calls once per sponge absorb
// and once per Merkle level:
//   permute_cols (a batch)          -> poseidon2_bb_permute
//   permute_cols per absorb         -> poseidon2_bb_leaf_sponge
//   permute_cols per level (two_to_one over the level)
//                                   -> poseidon2_bb_merkle_level / _tail
//
// Bound on the H100: integer multiplies.  One permutation is 8 * 16 * 4
// S-box products + 13 * (4 + 16 + 15) partial-round products = 967
// Montgomery products (each a 32x32 -> 64 multiply and two 32-bit ones)
// against 64 bytes in and out.  Design: one thread per state, the 16 lanes
// in registers for the whole permutation (and, in the sponge, across all
// ceil(L / 8) absorbs of a leaf), the round constants in __constant__
// memory (every thread reads the same word: a broadcast).  The external
// layer is adds only; the internal layer is the reference's: scale every
// lane, head = sum(lanes 1..15) - lane 0, lane i = sum(all) + lane i *
// 2^shift_(i-1).  Merkle levels wider than TAIL_W digests run one launch
// per level; all narrower levels run in one block, level after level in
// shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "bb.cuh"

namespace {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int N_FULL = 8;
constexpr int N_PARTIAL = 13;
constexpr int DIGEST = 8;
constexpr int TAIL_W = 512;        // widest level the tail kernel takes
constexpr int THREADS = 128;
constexpr int TAIL_THREADS = 256;

__constant__ uint32_t EXT_RC[N_FULL * WIDTH];
__constant__ uint32_t INT_RC[N_PARTIAL];
__constant__ uint32_t SCALE;
__constant__ uint32_t DIAG[WIDTH - 1];   // 2^shift_i, Montgomery form

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t x2 = bb::mul(x, x);
  const uint32_t x3 = bb::mul(x2, x);
  const uint32_t x4 = bb::mul(x2, x2);
  return bb::mul(x3, x4);
}

// y = M4 x with M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]]
// (reference apply_mat4, gates/poseidon2_babybear.rs:903-918).
__device__ __forceinline__ void mat4(uint32_t* x) {
  const uint32_t t01 = bb::add(x[0], x[1]);
  const uint32_t t23 = bb::add(x[2], x[3]);
  const uint32_t t0123 = bb::add(t01, t23);
  const uint32_t t01123 = bb::add(t0123, x[1]);
  const uint32_t t01233 = bb::add(t0123, x[3]);
  const uint32_t y3 = bb::add(t01233, bb::add(x[0], x[0]));
  const uint32_t y1 = bb::add(t01123, bb::add(x[2], x[2]));
  const uint32_t y0 = bb::add(t01123, t01);
  const uint32_t y2 = bb::add(t01233, t23);
  x[0] = y0;
  x[1] = y1;
  x[2] = y2;
  x[3] = y3;
}

__device__ __forceinline__ void external_layer(uint32_t s[WIDTH]) {
#pragma unroll
  for (int b = 0; b < WIDTH; b += 4) mat4(s + b);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t sum =
        bb::add(bb::add(s[k], s[4 + k]), bb::add(s[8 + k], s[12 + k]));
#pragma unroll
    for (int b = 0; b < WIDTH; b += 4) s[b + k] = bb::add(s[b + k], sum);
  }
}

__device__ __forceinline__ void internal_layer(uint32_t s[WIDTH]) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = bb::mul(s[i], SCALE);
  uint32_t part = s[1];
#pragma unroll
  for (int i = 2; i < WIDTH; ++i) part = bb::add(part, s[i]);
  const uint32_t full = bb::add(part, s[0]);
  s[0] = bb::sub(part, s[0]);
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) s[i] = bb::add(full, bb::mul(s[i], DIAG[i - 1]));
}

__device__ __forceinline__ void full_round(uint32_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(bb::add(s[i], EXT_RC[r * WIDTH + i]));
  external_layer(s);
}

__device__ void permute(uint32_t s[WIDTH]) {
  external_layer(s);
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);
  for (int r = 0; r < N_PARTIAL; ++r) {
    s[0] = sbox(bb::add(s[0], INT_RC[r]));
    internal_layer(s);
  }
  for (int r = HALF_FULL; r < N_FULL; ++r) full_round(s, r);
}

__global__ void permute_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                               int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[WIDTH];
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) s[t] = in[i * WIDTH + t];
  permute(s);
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) out[i * WIDTH + t] = s[t];
}

// rows (n, leaf_len) -> (n, num_out): overwrite-mode sponge from a zero
// state; the first num_out <= WIDTH lanes of the final state.
__global__ void leaf_sponge_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* out, int64_t n, int leaf_len,
                                   int num_out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* row = in + i * leaf_len;
  uint32_t s[WIDTH];
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) s[t] = 0;
  for (int c = 0; c < leaf_len; c += RATE) {
    const int k = leaf_len - c < RATE ? leaf_len - c : RATE;
#pragma unroll
    for (int t = 0; t < RATE; ++t)
      if (t < k) s[t] = row[c + t];
    permute(s);
  }
#pragma unroll
  for (int t = 0; t < WIDTH; ++t)
    if (t < num_out) out[i * num_out + t] = s[t];
}

// parent = first 8 lanes of permute(left || right): the pair is 16
// consecutive words, children 2i and 2i + 1.
__device__ __forceinline__ void two_to_one(const uint32_t* pair,
                                           uint32_t* dst) {
  uint32_t s[WIDTH];
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) s[t] = pair[t];
  permute(s);
#pragma unroll
  for (int t = 0; t < DIGEST; ++t) dst[t] = s[t];
}

__global__ void merkle_level_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* out, int64_t n_parents) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_parents) return;
  two_to_one(in + i * 2 * DIGEST, out + i * DIGEST);
}

// One block: digests (width, 8), width <= TAIL_W, through num_layers
// levels; level k (width >> (k + 1) digests) is written to out in order,
// levels back to back.
__global__ void merkle_tail_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* out, int width, int num_layers) {
  __shared__ uint32_t buf[2][TAIL_W * DIGEST];
  for (int e = threadIdx.x; e < width * DIGEST; e += blockDim.x)
    buf[0][e] = in[e];
  __syncthreads();
  int cur = 0;
  int64_t off = 0;
  for (int layer = 0; layer < num_layers; ++layer) {
    const int parents = width >> 1;
    for (int p = threadIdx.x; p < parents; p += blockDim.x) {
      uint32_t* dst = &buf[cur ^ 1][p * DIGEST];
      two_to_one(&buf[cur][p * 2 * DIGEST], dst);
#pragma unroll
      for (int t = 0; t < DIGEST; ++t) out[off + p * DIGEST + t] = dst[t];
    }
    __syncthreads();
    off += int64_t(parents) * DIGEST;
    width = parents;
    cur ^= 1;
  }
}

unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int poseidon2_bb_set_constants(const uint32_t* ext_rc,
                                          const uint32_t* int_rc,
                                          const uint32_t* scale,
                                          const uint32_t* diag) {
  cudaMemcpyToSymbol(EXT_RC, ext_rc, sizeof(uint32_t) * N_FULL * WIDTH);
  cudaMemcpyToSymbol(INT_RC, int_rc, sizeof(uint32_t) * N_PARTIAL);
  cudaMemcpyToSymbol(SCALE, scale, sizeof(uint32_t));
  cudaMemcpyToSymbol(DIAG, diag, sizeof(uint32_t) * (WIDTH - 1));
  return (int)cudaGetLastError();
}

extern "C" int poseidon2_bb_tail_width() { return TAIL_W; }

extern "C" int poseidon2_bb_permute(const uint32_t* in, uint32_t* out,
                                    long long n, void* stream) {
  if (n > 0)
    permute_kernel<<<blocks_for(n, THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

extern "C" int poseidon2_bb_leaf_sponge(const uint32_t* in, uint32_t* out,
                                        long long n, int leaf_len,
                                        int num_out, void* stream) {
  if (n > 0)
    leaf_sponge_kernel<<<blocks_for(n, THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(in, out, n, leaf_len,
                                                 num_out);
  return (int)cudaGetLastError();
}

extern "C" int poseidon2_bb_merkle_level(const uint32_t* in, uint32_t* out,
                                         long long n_parents, void* stream) {
  if (n_parents > 0)
    merkle_level_kernel<<<blocks_for(n_parents, THREADS), THREADS, 0,
                          (cudaStream_t)stream>>>(in, out, n_parents);
  return (int)cudaGetLastError();
}

extern "C" int poseidon2_bb_merkle_tail(const uint32_t* in, uint32_t* out,
                                        int width, int num_layers,
                                        void* stream) {
  if (width > TAIL_W) return (int)cudaErrorInvalidValue;
  merkle_tail_kernel<<<1, TAIL_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, width, num_layers);
  return (int)cudaGetLastError();
}
