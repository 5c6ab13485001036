// Poseidon width-12 permutation over Goldilocks and the two hashing
// kernels built on it: the overwrite-mode leaf sponge and the Merkle
// levels.  Round schedule of the reference (4 full, 22 partial, 4 full
// rounds, x^7 S-box, MDS out[r] = sum_i CIRC[i] s[(i + r) % 12] + DIAG[r]
// s[r]), bit-exact with hash/poseidon_gl.py:permute_host.
//
// Replaces these TPU kernels of plonky2_goldibear_tpu/ops/poseidon_gl.py:
//   permute_cols      -> poseidon_gl_permute
//   hash_cols_no_pad  -> poseidon_gl_leaf_sponge
//   tree_tail_cols and the per-level two_to_one_cols of build_levels_cols
//                     -> poseidon_gl_merkle_level / poseidon_gl_merkle_tail
//
// Bound on the H100: instruction issue.  A permutation moves 192 bytes and
// runs 118 S-boxes (472 field multiplies) and 30 MDS layers, so every
// kernel here is bound by its integer instructions and their pipes, not by
// memory.  Design:
//   * The MDS works on three limbs of 22, 22 and 20 bits in 32-bit sums
//     (each below 2^31), with its constants compile-time immediates; its
//     outputs are left as any u64 congruent mod p (one fold, no
//     canonicalisation), and the next round's constants seed its sums, so
//     a round constant costs no field addition.  A state held by one
//     thread runs the whole MDS as two CRT splits of the circulant whose
//     coefficients are all powers of two (mds_whole): shifts and adds, no
//     64-bit products.  gl::mul and gl::sbox (gl.cuh) are shared with the
//     NTT and the probes and are not specialised here.
//   * A state is held by a group of G threads (G = 1, 2, 4 or 12), each
//     with 12 / G lanes in registers; for G > 1 the MDS gathers the other
//     lanes with warp shuffles inside the group (12 lanes sit in a 16-
//     thread group, four threads of it spare), each thread computes its own
//     output lanes, and a partial round's S-box on lane 0 is applied as a
//     correction of the MDS, so the two do not wait on each other.  G
//     trades instructions per permutation (more with more threads) for
//     latency per permutation (less), so that a narrow Merkle level still
//     fills the card; the wrappers pick G and the block size per launch
//     (ops/poseidon_gl.py:group_for, merkle_plan).
//   * Merkle levels wider than the tail run one launch per level.  The tail
//     runs the top levels as independent subtrees, one block per node of
//     the last level (the cap), each folding its subtree in shared memory
//     with G = 12 and writing its slice of every level.
//
// The reference's fast partial rounds (a sparse layer per round with 64-bit
// constants) were tried here and cost more instructions per permutation
// than the small-constant MDS below (PERF.md), so they are not used.
#include <cstdint>
#include <cuda_runtime.h>

#include "poseidon_gl.cuh"

using namespace poseidon_gl;

namespace {

constexpr int DIGEST = 4;
constexpr int THREADS = 128;
constexpr int TAIL_MAX_LAYERS = 4;   // 8 parents x 16 threads per block

__global__ void permute_kernel(const uint64_t* __restrict__ in, uint64_t* out,
                               int64_t n) {
  __shared__ uint4 smem[RC2_WORDS / 4];
  const uint32_t* rc2 = rc2_to_shared<1>(smem);
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) s[t] = in[i * WIDTH + t];
  permute<1>(s, 0, 0, rc2);
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) out[i * WIDTH + t] = s[t];
}

// rows (n, leaf_len) -> (n, num_out): overwrite-mode sponge; the first
// num_out <= WIDTH lanes of the final state (the digest is num_out = 4).
// One state per group of G threads.
template <int G>
__global__ void leaf_sponge_kernel(const uint64_t* __restrict__ in,
                                   uint64_t* out, int64_t n, int leaf_len,
                                   int num_out) {
  constexpr int L = Group<G>::L;
  __shared__ uint4 smem[G == 1 ? RC2_WORDS / 4 : 1];
  const uint32_t* rc2 = rc2_to_shared<G>(smem);
  const Member<G> m(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (m.group >= n) return;   // whole groups leave together
  const uint64_t* row = in + m.group * leaf_len;
  uint64_t s[L];
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = 0;
  for (int c = 0; c < leaf_len; c += RATE) {
    const int take = leaf_len - c < RATE ? leaf_len - c : RATE;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int lane = m.q + G * j;
      if (lane < take) s[j] = row[c + lane];
    }
    permute<G>(s, m.q, m.mask, rc2);
  }
  if (m.spare) return;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int lane = m.q + G * j;
    if (lane < num_out) out[m.group * num_out + lane] = s[j];
  }
}

// two_to_one(pair[0:4], pair[4:8]) into dst[0:4] by the calling group.
template <int G>
__device__ __forceinline__ void two_to_one(const uint64_t* pair, uint64_t* dst,
                                           const Member<G>& m,
                                           const uint32_t* rc2) {
  constexpr int L = Group<G>::L;
  uint64_t s[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int lane = m.q + G * j;
    s[j] = lane < 2 * DIGEST ? pair[lane] : 0;
  }
  permute<G>(s, m.q, m.mask, rc2);
  if (m.spare) return;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int lane = m.q + G * j;
    if (lane < DIGEST) dst[lane] = s[j];
  }
}

// digests (2 n_parents, 4) natural order -> parents (n_parents, 4):
// parent i = two_to_one(child 2i, child 2i + 1), one per group of G threads.
template <int G>
__global__ void merkle_level_kernel(const uint64_t* __restrict__ in,
                                    uint64_t* out, int64_t n_parents) {
  __shared__ uint4 smem[G == 1 ? RC2_WORDS / 4 : 1];
  const uint32_t* rc2 = rc2_to_shared<G>(smem);
  const Member<G> m(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (m.group >= n_parents) return;
  two_to_one<G>(in + m.group * 2 * DIGEST, out + m.group * DIGEST, m, rc2);
}

// The top num_layers levels above digests (width, 4) as width >> num_layers
// independent subtrees, one block each (16 threads per parent of its first
// level).  Level k (width >> (k + 1) digests) is written to out in natural
// order, levels back to back; block b writes its slice of each.
__global__ void merkle_tail_kernel(const uint64_t* __restrict__ in,
                                   uint64_t* out, int width, int num_layers) {
  constexpr int G = 12;
  __shared__ uint64_t buf[2][(1 << TAIL_MAX_LAYERS) * DIGEST];
  const int sub = 1 << num_layers;          // digests of one subtree
  const int64_t base = int64_t(blockIdx.x) * sub;
  for (int e = threadIdx.x; e < sub * DIGEST; e += blockDim.x)
    buf[0][e] = in[base * DIGEST + e];
  __syncthreads();
  const Member<G> m(threadIdx.x);
  int cur = 0;
  int64_t off = 0;       // the level's first digest in out
  int w = width;         // the level's input width
  for (int layer = 0, parents = sub >> 1; layer < num_layers;
       ++layer, parents >>= 1) {
    if (m.group < parents) {
      uint64_t* dst = &buf[cur ^ 1][m.group * DIGEST];
      two_to_one<G>(&buf[cur][m.group * 2 * DIGEST], dst, m, nullptr);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < parents * DIGEST; e += blockDim.x)
      out[(off + int64_t(blockIdx.x) * parents) * DIGEST + e] =
          buf[cur ^ 1][e];
    off += w >> 1;
    w >>= 1;
    cur ^= 1;
  }
}

template <int G>
int launch_sponge(const uint64_t* in, uint64_t* out, long long n, int leaf_len,
                  int num_out, int threads, cudaStream_t stream) {
  const long long total = n * Group<G>::SPAN;
  leaf_sponge_kernel<G><<<unsigned((total + threads - 1) / threads), threads, 0,
                          stream>>>(in, out, n, leaf_len, num_out);
  return (int)cudaGetLastError();
}

template <int G>
int launch_level(const uint64_t* in, uint64_t* out, long long n_parents,
                 int threads, cudaStream_t stream) {
  const long long total = n_parents * Group<G>::SPAN;
  merkle_level_kernel<G><<<unsigned((total + threads - 1) / threads), threads,
                           0, stream>>>(in, out, n_parents);
  return (int)cudaGetLastError();
}

bool valid_block(int threads) {
  return threads > 0 && threads <= 1024 && threads % 32 == 0;
}

}  // namespace

extern "C" int poseidon_gl_set_constants(const uint64_t* rc) {
  return set_constants(rc);
}

extern "C" int poseidon_gl_tail_max_layers() { return TAIL_MAX_LAYERS; }

extern "C" int poseidon_gl_permute(const uint64_t* in, uint64_t* out,
                                   long long n, void* stream) {
  if (n > 0)
    permute_kernel<<<unsigned((n + THREADS - 1) / THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

// group: threads per state (1, 2, 4 or 12); threads: per block, a multiple
// of 32.
extern "C" int poseidon_gl_leaf_sponge(const uint64_t* in, uint64_t* out,
                                       long long n, int leaf_len, int num_out,
                                       int group, int threads, void* stream) {
  if (n <= 0) return 0;
  if (!valid_block(threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: return launch_sponge<1>(in, out, n, leaf_len, num_out, threads, st);
    case 2: return launch_sponge<2>(in, out, n, leaf_len, num_out, threads, st);
    case 4: return launch_sponge<4>(in, out, n, leaf_len, num_out, threads, st);
    case 12: return launch_sponge<12>(in, out, n, leaf_len, num_out, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int poseidon_gl_merkle_level(const uint64_t* in, uint64_t* out,
                                        long long n_parents, int group,
                                        int threads, void* stream) {
  if (n_parents <= 0) return 0;
  if (!valid_block(threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: return launch_level<1>(in, out, n_parents, threads, st);
    case 2: return launch_level<2>(in, out, n_parents, threads, st);
    case 4: return launch_level<4>(in, out, n_parents, threads, st);
    case 12: return launch_level<12>(in, out, n_parents, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}

// width >> num_layers blocks of 16 << (num_layers - 1) threads.
extern "C" int poseidon_gl_merkle_tail(const uint64_t* in, uint64_t* out,
                                       int width, int num_layers,
                                       void* stream) {
  if (num_layers < 1 || num_layers > TAIL_MAX_LAYERS ||
      width < (1 << num_layers))
    return (int)cudaErrorInvalidValue;
  merkle_tail_kernel<<<unsigned(width >> num_layers), 16 << (num_layers - 1),
                       0, (cudaStream_t)stream>>>(in, out, width, num_layers);
  return (int)cudaGetLastError();
}
