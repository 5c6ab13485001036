// Poseidon width-12 permutation over Goldilocks and the two hashing
// kernels built on it: the overwrite-mode leaf sponge and the Merkle
// levels.  Naive round schedule of the reference (4 full, 22 partial,
// 4 full rounds, x^7 S-box, MDS out[r] = sum_i CIRC[i] s[(i + r) % 12]
// + DIAG[r] s[r]), bit-exact with hash/poseidon_gl.py:permute_host.
//
// Replaces these TPU kernels of plonky2_goldibear_tpu/ops/poseidon_gl.py:
//   permute_cols      -> poseidon_gl_permute
//   hash_cols_no_pad  -> poseidon_gl_leaf_sponge
//   tree_tail_cols and the per-level two_to_one_cols of build_levels_cols
//                     -> poseidon_gl_merkle_level / poseidon_gl_merkle_tail
//
// Bound on the H100: integer multiplies.  One permutation is 8*12*4 + 22*4
// = 472 field multiplies (each four 32x32 products: 1888 32-bit multiplies)
// against 96 bytes in and out, so the card's integer-multiply rate bounds
// every kernel here, not its memory.  Design: one thread per state, the 12
// lanes in registers for the whole permutation (and, in the sponge, across
// all ceil(L / 8) absorbs), round constants in __constant__ memory (every
// thread reads the same word: a broadcast), and the MDS as a circulant of
// small integers accumulated exactly in two 64-bit sums of 32-bit limbs
// (< 2^41 each), reduced once per lane.  The TPU's f32 MXU limb planes are
// not needed.  The Merkle levels above TAIL_W digests run one launch per
// level; all narrower levels run in one block, level after level in shared
// memory, so the top of the tree is one launch and not a run of tiny ones.
#include <cstdint>
#include <cuda_runtime.h>

#include "gl.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int N_PARTIAL = 22;
constexpr int N_ROUNDS = 2 * HALF_FULL + N_PARTIAL;
constexpr int DIGEST = 4;
constexpr int TAIL_W = 512;        // widest level the tail kernel takes
constexpr int THREADS = 128;
constexpr int TAIL_THREADS = 256;

__constant__ uint64_t RC[N_ROUNDS * WIDTH];
__constant__ uint64_t CIRC[WIDTH];
__constant__ uint64_t DIAG[WIDTH];

__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  uint64_t lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    lo[i] = s[i] & gl::EPS;
    hi[i] = s[i] >> 32;
  }
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) {
    uint64_t acc_lo = DIAG[r] * lo[r];
    uint64_t acc_hi = DIAG[r] * hi[r];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      acc_lo += CIRC[i] * lo[(i + r) % WIDTH];
      acc_hi += CIRC[i] * hi[(i + r) % WIDTH];
    }
    // value = acc_lo + acc_hi * 2^32 < 2^74
    const uint64_t h = acc_hi + (acc_lo >> 32);
    s[r] = gl::reduce96((acc_lo & gl::EPS) | (h << 32), h >> 32);
  }
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int round) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl::sbox(gl::add(s[i], RC[round * WIDTH + i]));
  mds(s);
}

__device__ __forceinline__ void partial_round(uint64_t s[WIDTH], int round) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl::add(s[i], RC[round * WIDTH + i]);
  s[0] = gl::sbox(s[0]);
  mds(s);
}

__device__ void permute(uint64_t s[WIDTH]) {
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);
  for (int r = HALF_FULL; r < HALF_FULL + N_PARTIAL; ++r) partial_round(s, r);
  for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) full_round(s, r);
}

__global__ void permute_kernel(const uint64_t* __restrict__ in, uint64_t* out,
                               int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) s[t] = in[i * WIDTH + t];
  permute(s);
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) out[i * WIDTH + t] = s[t];
}

// rows (n, leaf_len) -> (n, num_out): overwrite-mode sponge; the first
// num_out <= WIDTH lanes of the final state (the digest is num_out = 4).
__global__ void leaf_sponge_kernel(const uint64_t* __restrict__ in,
                                   uint64_t* out, int64_t n, int leaf_len,
                                   int num_out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t* row = in + i * leaf_len;
  uint64_t s[WIDTH];
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

__device__ __forceinline__ void two_to_one(const uint64_t* pair,
                                           uint64_t* dst) {
  uint64_t s[WIDTH];
#pragma unroll
  for (int t = 0; t < 2 * DIGEST; ++t) s[t] = pair[t];
#pragma unroll
  for (int t = 2 * DIGEST; t < WIDTH; ++t) s[t] = 0;
  permute(s);
#pragma unroll
  for (int t = 0; t < DIGEST; ++t) dst[t] = s[t];
}

// digests (2 n_parents, 4) natural order -> parents (n_parents, 4):
// parent i = two_to_one(child 2i, child 2i + 1).
__global__ void merkle_level_kernel(const uint64_t* __restrict__ in,
                                    uint64_t* out, int64_t n_parents) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_parents) return;
  two_to_one(in + i * 2 * DIGEST, out + i * DIGEST);
}

// One block: digests (width, 4), width <= TAIL_W, through num_layers levels.
// Level k (width >> (k + 1) digests) is written to out in order, levels
// back to back.
__global__ void merkle_tail_kernel(const uint64_t* __restrict__ in,
                                   uint64_t* out, int width, int num_layers) {
  __shared__ uint64_t buf[2][TAIL_W * DIGEST];
  for (int e = threadIdx.x; e < width * DIGEST; e += blockDim.x)
    buf[0][e] = in[e];
  __syncthreads();
  int cur = 0;
  int64_t off = 0;
  for (int layer = 0; layer < num_layers; ++layer) {
    const int parents = width >> 1;
    for (int p = threadIdx.x; p < parents; p += blockDim.x) {
      uint64_t* dst = &buf[cur ^ 1][p * DIGEST];
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

extern "C" int poseidon_gl_set_constants(const uint64_t* rc,
                                         const uint64_t* circ,
                                         const uint64_t* diag) {
  cudaMemcpyToSymbol(RC, rc, sizeof(uint64_t) * N_ROUNDS * WIDTH);
  cudaMemcpyToSymbol(CIRC, circ, sizeof(uint64_t) * WIDTH);
  cudaMemcpyToSymbol(DIAG, diag, sizeof(uint64_t) * WIDTH);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_gl_tail_width() { return TAIL_W; }

extern "C" int poseidon_gl_permute(const uint64_t* in, uint64_t* out,
                                   long long n, void* stream) {
  if (n > 0)
    permute_kernel<<<blocks_for(n, THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_gl_leaf_sponge(const uint64_t* in, uint64_t* out,
                                       long long n, int leaf_len, int num_out,
                                       void* stream) {
  if (n > 0)
    leaf_sponge_kernel<<<blocks_for(n, THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(in, out, n, leaf_len,
                                                 num_out);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_gl_merkle_level(const uint64_t* in, uint64_t* out,
                                        long long n_parents, void* stream) {
  if (n_parents > 0)
    merkle_level_kernel<<<blocks_for(n_parents, THREADS), THREADS, 0,
                          (cudaStream_t)stream>>>(in, out, n_parents);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_gl_merkle_tail(const uint64_t* in, uint64_t* out,
                                       int width, int num_layers,
                                       void* stream) {
  if (width > TAIL_W) return (int)cudaErrorInvalidValue;
  merkle_tail_kernel<<<1, TAIL_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, width, num_layers);
  return (int)cudaGetLastError();
}
