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
//                                   -> poseidon2_bb_merkle_level / _subtree
//
// Bound on the H100: integer multiplies.  A permutation is 8 * 16 * 4
// S-box products and 13 * (4 + 2 + 15) partial-round products, 785
// Montgomery products (each a 32x32 -> 64 multiply and two 32-bit ones),
// against 64 bytes in and out; a narrow Merkle level, though, is one
// permutation's latency.  Design:
//   * The internal layer scales the lanes' sum, not each lane: head =
//     SCALE (sum(lanes 1..15) - lane 0), lane i = SCALE sum(all) + lane i
//     (SCALE 2^shift_(i-1)), the products of the constants precomputed
//     (SCALED_DIAG): two products and one a lane where the reference
//     takes two a lane.  The external layer is adds only.
//   * A state is held by a group of G threads, each with 16 / G
//     consecutive lanes in registers: G = 1 for the permutation, the
//     sponge and the widest levels, G = 4 (one M4 block a thread) for the
//     other levels that fill the card, G = 16 in the subtrees.  For G > 1
//     the external layer's sums across M4 blocks (and, at G = 16, the M4
//     itself) are warp shuffles inside the group; every thread of a group
//     runs lane 0's S-box of a partial round itself.  At G = 4 the
//     internal layer's sum is one shuffle reduction a round; at G = 16
//     the 13 partial rounds take one reduction in all
//     (partial_rounds_fast).  A group keeps its round constants in
//     registers, loaded once before the first round.  The wrapper picks
//     G and the block size per level (ops/poseidon2_bb.py:group_for,
//     merkle_plan).
//   * Wide Merkle levels run one launch per level.  The levels too narrow
//     to fill the card at G = 4 run as independent subtrees of up to
//     SUBTREE_MAX_LAYERS levels, one block each, folded in shared memory
//     with 16 threads per parent; the last such launch (the tail) has one
//     block per node of the cap.
//   * The permutation keeps one thread per state (16 lanes in registers
//     for the whole permutation), the round constants in __constant__
//     memory (every thread reads the same word: a broadcast).  Groups read
//     their per-lane constants from a global copy through L1 (the constant
//     cache serialises a warp's distinct addresses).
//   * The leaf sponge holds a state in a group of G = 1, 4 or 16 threads
//     for all absorbs of a leaf, G chosen per launch
//     (ops/poseidon2_bb.py:sponge_plan): one thread where the leaves fill
//     the card, more for the narrow FRI layers, whose permutations would
//     otherwise be one thread's latency.  A wide sponge runs at the
//     permute kernel's rate per permutation: it is bound by instruction
//     issue, not by its row loads (a probe build without them,
//     poseidon2_bb_leaf_sponge_noload, times the difference).
//   * Fewer instructions where a bound allows it (bb.cuh): the S-box's
//     intermediate products stay in (0, 2p) where the other factor is
//     canonical; the internal layer's lane i, SCALE (u + y) + s_i d_i, is
//     one fused multiply-add of two canonical products and one reduction;
//     its head takes u - y + p < 2p unreduced; the M4 blocks take 8 adds
//     and 2 doublings (Horizen's order).  Every lane is canonical at the
//     end of every round.  A state in one thread is short of warps (a
//     2^15-leaf sponge gives an SM 8), so the partial rounds sum the lanes
//     in a tree: with the 14 adds in a chain the fused lanes lost to the
//     unfused ones, with the tree they win.
#include <cstdint>
#include <cuda_runtime.h>

#include "poseidon2_bb.cuh"

using namespace poseidon2_bb;

namespace {

constexpr int DIGEST = 8;
constexpr int THREADS = 128;
constexpr int SUBTREE_MAX_LAYERS = 5;   // 16 parents at a subtree's first level

__global__ void permute_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                               int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[WIDTH];
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) s[t] = in[i * WIDTH + t];
  permute<1>(s, 0, 0, Consts<1>(0));
#pragma unroll
  for (int t = 0; t < WIDTH; ++t) out[i * WIDTH + t] = s[t];
}

// rows (n, leaf_len) -> (n, num_out): overwrite-mode sponge from a zero
// state, one state per group of G threads for all absorbs of its row; the
// first num_out <= WIDTH lanes of the final state.  Without LOADS (a probe
// build, never on the main path) each absorb takes the leaf's index plus
// the position (one add, < p for fewer than 2^30 leaves) in place of the
// row's value: the sponge's time without its row loads.
template <int G, bool LOADS>
__global__ void leaf_sponge_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* out, int64_t n, int leaf_len,
                                   int num_out) {
  constexpr int L = Group<G>::L;
  const Member<G> m(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (m.group >= n) return;   // whole groups leave together
  const Consts<G> c(m.q);
  const uint32_t* row = in + m.group * leaf_len;
  uint32_t s[L];
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = 0;
  for (int a = 0; a < leaf_len; a += RATE) {
    const int k = leaf_len - a < RATE ? leaf_len - a : RATE;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int lane = m.q * L + j;
      if (lane < k)
        s[j] = LOADS ? row[a + lane] : uint32_t(m.group + a + lane);
    }
    permute<G>(s, m.q, m.mask, c);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int lane = m.q * L + j;
    if (lane < num_out) out[m.group * num_out + lane] = s[j];
  }
}

// dst[0:8] = the first 8 lanes of permute(pair[0:16]) (pair = left ||
// right, children 2i and 2i + 1), by the calling group.
template <int G>
__device__ __forceinline__ void two_to_one(const uint32_t* pair, uint32_t* dst,
                                           const Member<G>& m,
                                           const Consts<G>& c) {
  constexpr int L = Group<G>::L;
  uint32_t s[L];
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = pair[m.q * L + j];
  permute<G>(s, m.q, m.mask, c);
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (m.q * L + j < DIGEST) dst[m.q * L + j] = s[j];
}

// digests (2 n_parents, 8) natural order -> parents (n_parents, 8), one
// parent per group of G threads.
template <int G>
__global__ void merkle_level_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* out, int64_t n_parents) {
  const Member<G> m(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (m.group >= n_parents) return;   // whole groups leave together
  two_to_one<G>(in + m.group * 2 * DIGEST, out + m.group * DIGEST, m,
                Consts<G>(m.q));
}

// num_layers levels above digests (width, 8) as width >> num_layers
// independent subtrees, one block each (SUBTREE_G threads per parent of
// its first level): the top of a tree (one block per cap node) or a band
// of narrow levels below it.  Level k (width >> (k + 1) digests) is
// written to out in natural order, levels back to back; block b writes its
// slice of each.
__global__ void merkle_subtree_kernel(const uint32_t* __restrict__ in,
                                      uint32_t* out, int width,
                                      int num_layers) {
  constexpr int G = SUBTREE_G;
  __shared__ uint32_t buf[2][(1 << SUBTREE_MAX_LAYERS) * DIGEST];
  const int sub = 1 << num_layers;          // digests of one subtree
  const int64_t base = int64_t(blockIdx.x) * sub;
  for (int e = threadIdx.x; e < sub * DIGEST; e += blockDim.x)
    buf[0][e] = in[base * DIGEST + e];
  const Member<G> m(threadIdx.x);
  const Consts<G> c(m.q);
  __syncthreads();
  int cur = 0;
  int64_t off = 0;       // the level's first digest in out
  int w = width;         // the level's input width
  for (int layer = 0, parents = sub >> 1; layer < num_layers;
       ++layer, parents >>= 1) {
    if (m.group < parents)
      two_to_one<G>(&buf[cur][m.group * 2 * DIGEST],
                    &buf[cur ^ 1][m.group * DIGEST], m, c);
    __syncthreads();
    for (int e = threadIdx.x; e < parents * DIGEST; e += blockDim.x)
      out[(off + int64_t(blockIdx.x) * parents) * DIGEST + e] = buf[cur ^ 1][e];
    off += w >> 1;
    w >>= 1;
    cur ^= 1;
  }
}

unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

bool valid_block(int threads) {
  return threads > 0 && threads <= 1024 && threads % 32 == 0;
}

template <int G>
int launch_level(const uint32_t* in, uint32_t* out, long long n_parents,
                 int threads, cudaStream_t stream) {
  merkle_level_kernel<G><<<blocks_for(n_parents * G, threads), threads, 0,
                           stream>>>(in, out, n_parents);
  return (int)cudaGetLastError();
}

template <int G, bool LOADS>
int launch_sponge(const uint32_t* in, uint32_t* out, long long n,
                  int leaf_len, int num_out, int threads, cudaStream_t stream) {
  leaf_sponge_kernel<G, LOADS><<<blocks_for(n * G, threads), threads, 0,
                                 stream>>>(in, out, n, leaf_len, num_out);
  return (int)cudaGetLastError();
}

template <bool LOADS>
int sponge(const uint32_t* in, uint32_t* out, long long n, int leaf_len,
           int num_out, int group, int threads, void* stream) {
  if (n <= 0) return 0;
  if (!valid_block(threads) || leaf_len < 1 || num_out < 1 ||
      num_out > WIDTH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: return launch_sponge<1, LOADS>(in, out, n, leaf_len, num_out, threads, st);
    case 4: return launch_sponge<4, LOADS>(in, out, n, leaf_len, num_out, threads, st);
    case 16: return launch_sponge<16, LOADS>(in, out, n, leaf_len, num_out, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ext_rc (8 x 16), int_rc (13), scale (1), scaled_diag (16: lane 0 unused,
// lane i d_i = SCALE 2^shift_(i-1)), diag_pows (16 x 14: d_i^k),
// diag_pow_sums (13: sum_(i >= 1) d_i^j), all Montgomery forms.
extern "C" int poseidon2_bb_set_constants(const uint32_t* ext_rc,
                                          const uint32_t* int_rc,
                                          const uint32_t* scale,
                                          const uint32_t* scaled_diag,
                                          const uint32_t* diag_pows,
                                          const uint32_t* diag_pow_sums) {
  return set_constants(ext_rc, int_rc, scale, scaled_diag, diag_pows,
                       diag_pow_sums);
}

extern "C" int poseidon2_bb_subtree_max_layers() { return SUBTREE_MAX_LAYERS; }

extern "C" int poseidon2_bb_permute(const uint32_t* in, uint32_t* out,
                                    long long n, void* stream) {
  if (n > 0)
    permute_kernel<<<blocks_for(n, THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

// group: threads per state (1, 4 or 16); threads: per block, a multiple
// of 32.
extern "C" int poseidon2_bb_leaf_sponge(const uint32_t* in, uint32_t* out,
                                        long long n, int leaf_len,
                                        int num_out, int group, int threads,
                                        void* stream) {
  return sponge<true>(in, out, n, leaf_len, num_out, group, threads, stream);
}

// The probe build: the same launch, no row loads (`in` is not read).
extern "C" int poseidon2_bb_leaf_sponge_noload(const uint32_t* in,
                                               uint32_t* out, long long n,
                                               int leaf_len, int num_out,
                                               int group, int threads,
                                               void* stream) {
  return sponge<false>(in, out, n, leaf_len, num_out, group, threads, stream);
}

// group: threads per state (1 or 4); threads: per block, a multiple of 32.
extern "C" int poseidon2_bb_merkle_level(const uint32_t* in, uint32_t* out,
                                         long long n_parents, int group,
                                         int threads, void* stream) {
  if (n_parents <= 0) return 0;
  if (!valid_block(threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: return launch_level<1>(in, out, n_parents, threads, st);
    case 4: return launch_level<4>(in, out, n_parents, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}

// width >> num_layers blocks of SUBTREE_G << (num_layers - 1) threads.
extern "C" int poseidon2_bb_merkle_subtree(const uint32_t* in, uint32_t* out,
                                           int width, int num_layers,
                                           void* stream) {
  if (num_layers < 1 || num_layers > SUBTREE_MAX_LAYERS ||
      width < (1 << num_layers))
    return (int)cudaErrorInvalidValue;
  merkle_subtree_kernel<<<unsigned(width >> num_layers),
                          SUBTREE_G << (num_layers - 1), 0,
                          (cudaStream_t)stream>>>(in, out, width, num_layers);
  return (int)cudaGetLastError();
}
