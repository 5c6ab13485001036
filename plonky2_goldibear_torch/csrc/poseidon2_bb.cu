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

#include "bb.cuh"

namespace {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int N_FULL = 8;
constexpr int N_PARTIAL = 13;
constexpr int DIGEST = 8;
constexpr int THREADS = 128;
constexpr int SUBTREE_MAX_LAYERS = 5;   // 16 parents at a subtree's first level
constexpr int SUBTREE_G = 16;           // threads per parent in a subtree

__constant__ uint32_t EXT_RC[N_FULL * WIDTH];
__constant__ uint32_t INT_RC[N_PARTIAL];
__constant__ uint32_t SCALE;
__constant__ uint32_t SCALED_DIAG[WIDTH];      // lane 0 unused
__device__ uint32_t EXT_RC_LANES[N_FULL * WIDTH];   // the same, for groups
__device__ uint32_t INT_RC_LANES[N_PARTIAL];
__device__ uint32_t SCALE_LANES[1];
__device__ uint32_t SCALED_DIAG_LANES[WIDTH];
// d_i^k for lane i (d_i = SCALE 2^shift_(i-1)), k = 0 .. 13, and
// S_j = sum_(i >= 1) d_i^j, j < 13: the partial rounds of a subtree's group
__device__ uint32_t DIAG_POW_LANES[WIDTH * (N_PARTIAL + 1)];
__constant__ uint32_t DIAG_POW_SUMS[N_PARTIAL];

// x^7 of a canonical x, canonical.  Each product has a canonical factor
// and one below 2p, so it stays below 2p^2 < p 2^32 (bb.cuh): x^2 and x^3
// are kept in (0, 2p), x^2 and x^4 also canonical.
__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t r2 = bb::redc_signed(uint64_t(x) * x);   // in (-p, p)
  const uint32_t x2l = r2 + bb::P;                        // in (0, 2p)
  const uint32_t x2 = bb::fold(r2, x2l);
  const uint32_t x3l = bb::mul_lazy(x2l, x);              // in (0, 2p)
  const uint32_t x4 = bb::mul(x2l, x2);
  return bb::mul(x3l, x4);
}

__device__ __forceinline__ uint32_t twice(uint32_t x) { return bb::add(x, x); }

// G threads hold one state; thread q of the group holds lanes q L .. q L +
// L - 1 (L = 16 / G).  Groups are aligned in the warp.
template <int G>
struct Group {
  static_assert(G == 1 || G == 4 || G == 16, "the groups the kernels use");
  static constexpr int L = WIDTH / G;
};

template <int G>
__device__ __forceinline__ uint32_t xor_sum(uint32_t v, unsigned mask,
                                            int first) {
#pragma unroll
  for (int d = first; d < G; d <<= 1)
    v = bb::add(v, __shfl_xor_sync(mask, v, d, G));
  return v;
}

// y = M4 x with M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]]: y_k =
// sum(x) + x_k + 2 x_(k+1 mod 4) (reference apply_mat4,
// gates/poseidon2_babybear.rs:903-918), in 8 adds and 2 doublings.
__device__ __forceinline__ void mat4(uint32_t* x) {
  const uint32_t t01 = bb::add(x[0], x[1]);
  const uint32_t t23 = bb::add(x[2], x[3]);
  const uint32_t t0123 = bb::add(t01, t23);
  const uint32_t t01123 = bb::add(t0123, x[1]);   // x0 + 2 x1 + x2 + x3
  const uint32_t t01233 = bb::add(t0123, x[3]);   // x0 + x1 + x2 + 2 x3
  const uint32_t y3 = bb::add(t01233, twice(x[0]));
  const uint32_t y1 = bb::add(t01123, twice(x[2]));
  x[0] = bb::add(t01123, t01);
  x[2] = bb::add(t01233, t23);
  x[1] = y1;
  x[3] = y3;
}

// The external layer: M4 on each block of four lanes, then each lane plus
// the sum of its congruence class (mod 4) over the four blocks.
template <int G>
__device__ __forceinline__ void external_layer(uint32_t s[], int q,
                                               unsigned mask) {
  constexpr int L = Group<G>::L;
  if constexpr (L >= 4) {            // G = 1, 4: whole M4 blocks a thread
#pragma unroll
    for (int b = 0; b < L; b += 4) mat4(s + b);
    uint32_t sum[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sum[k] = s[k];
#pragma unroll
      for (int b = 4; b < L; b += 4) sum[k] = bb::add(sum[k], s[b + k]);
      sum[k] = xor_sum<G>(sum[k], mask, 1);
    }
#pragma unroll
    for (int b = 0; b < L; b += 4)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[b + k] = bb::add(s[b + k], sum[k]);
  } else {                           // G = 16: one lane, its block in q & ~3
    const uint32_t t = xor_sum<4>(s[0], mask, 1);
    const uint32_t next =
        __shfl_sync(mask, s[0], (q & ~3) | ((q + 1) & 3), G);
    const uint32_t y = bb::add(bb::add(t, s[0]), twice(next));
    s[0] = bb::add(y, xor_sum<G>(y, mask, 4));
  }
}

// The round constants a thread uses.  One-thread states (G = 1) read them
// from constant memory as they go (a warp reads one word: a broadcast).
// Groups load theirs into registers once, before the first round, from
// global copies (the constant cache serialises a warp's distinct
// addresses, and a narrow Merkle level would wait on a miss every round).
template <int G>
struct Consts {
  static constexpr int L = Group<G>::L;
  uint32_t ext[N_FULL][L], in[N_PARTIAL], scale, sd[L], dpow[L][N_PARTIAL + 1];
  __device__ __forceinline__ explicit Consts(int q) {   // unused ones drop out
#pragma unroll
    for (int r = 0; r < N_FULL; ++r)
#pragma unroll
      for (int j = 0; j < L; ++j) ext[r][j] = __ldg(EXT_RC_LANES + r * WIDTH + q * L + j);
#pragma unroll
    for (int r = 0; r < N_PARTIAL; ++r) in[r] = __ldg(INT_RC_LANES + r);
    scale = __ldg(SCALE_LANES);
#pragma unroll
    for (int j = 0; j < L; ++j) sd[j] = __ldg(SCALED_DIAG_LANES + q * L + j);
#pragma unroll
    for (int j = 0; j < L; ++j)
#pragma unroll
      for (int k = 0; k <= N_PARTIAL; ++k)
        dpow[j][k] = __ldg(DIAG_POW_LANES + (q * L + j) * (N_PARTIAL + 1) + k);
  }
  __device__ __forceinline__ uint32_t ext_rc(int r, int j) const { return ext[r][j]; }
  __device__ __forceinline__ uint32_t int_rc(int r) const { return in[r]; }
  __device__ __forceinline__ uint32_t scale_() const { return scale; }
  __device__ __forceinline__ uint32_t diag(int j) const { return sd[j]; }
};

template <>
struct Consts<1> {
  __device__ __forceinline__ explicit Consts(int) {}
  __device__ __forceinline__ uint32_t ext_rc(int r, int j) const { return EXT_RC[r * WIDTH + j]; }
  __device__ __forceinline__ uint32_t int_rc(int r) const { return INT_RC[r]; }
  __device__ __forceinline__ uint32_t scale_() const { return SCALE; }
  __device__ __forceinline__ uint32_t diag(int j) const { return SCALED_DIAG[j]; }
};

template <int G>
__device__ __forceinline__ void full_round(uint32_t s[], int r, int q,
                                           unsigned mask, const Consts<G>& c) {
  constexpr int L = Group<G>::L;
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = sbox(bb::add(s[j], c.ext_rc(r, j)));
  external_layer<G>(s, q, mask);
}

// The sum of lanes 1..15 among this thread's lanes (thread 0 leaves out
// its s[0], lane 0), in a pairwise tree: depth 4 adds for one thread, not
// 14, so the sum does not hold up the next round.
template <int G>
__device__ __forceinline__ uint32_t sum_lanes_1_15(const uint32_t s[], int q) {
  constexpr int L = Group<G>::L;
  if constexpr (L == 1) {
    return q == 0 ? 0u : s[0];
  } else if constexpr (G == 1) {
    uint32_t t[8];
#pragma unroll
    for (int j = 0; j < 7; ++j) t[j] = bb::add(s[1 + 2 * j], s[2 + 2 * j]);
    t[7] = s[15];
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = bb::add(t[j], t[j + w]);
    return t[0];
  } else {
    static_assert(L == 4, "the groups the kernels use");
    const uint32_t a = q == 0 ? s[1] : bb::add(s[0], s[1]);
    return bb::add(a, bb::add(s[2], s[3]));
  }
}

// Lane 0 += INT_RC[r], x^7 on lane 0, then the internal layer: with u the
// sum of lanes 1..15 and y lane 0's S-box, head = SCALE (u - y), lane i =
// SCALE (u + y) + s_i d_i.  Lane i is one reduction of the fused products
// (u + y) SCALE + s_i d_i, both of canonical factors: < 2p^2 < p 2^32.  The
// head's factor u - y + p < 2p goes in unreduced (the other is SCALE < p,
// bb.cuh).
template <int G>
__device__ __forceinline__ void partial_round(uint32_t s[], int r, int q,
                                              unsigned mask,
                                              const Consts<G>& c) {
  constexpr int L = Group<G>::L;
  uint32_t x0 = s[0];
  if constexpr (G > 1) x0 = __shfl_sync(mask, s[0], 0, G);   // lane 0
  const uint32_t y0 = sbox(bb::add(x0, c.int_rc(r)));
  uint32_t u = sum_lanes_1_15<G>(s, q);
  if constexpr (G > 1) u = xor_sum<G>(u, mask, 1);
  const uint32_t head = bb::mul(u - y0 + bb::P, c.scale_());
  const uint64_t full = uint64_t(bb::add(u, y0)) * c.scale_();
#pragma unroll
  for (int j = 0; j < L; ++j)
    s[j] = (j == 0 && q == 0) ? head
                              : bb::redc(uint64_t(s[j]) * c.diag(j) + full);
}

// The 13 partial rounds for a group of 16 threads (a subtree's), with one
// shuffle reduction in all instead of one a round.  The internal layer leaves
// lanes 1..15 affine: s_i' = full_t + s_i d_i, full_t = SCALE (u_t + y_t)
// with u_t the sum of lanes 1..15 and y_t lane 0's S-box; so u_t = P_t +
// sum_(j < t) full_(t-1-j) S_j, P_k = sum_(i >= 1) s_i d_i^k of the state
// before the first partial round.  The group reduces P_0 .. P_12 once;
// every thread then runs lane 0 and u through the 13 rounds itself (no
// shuffle), and finally s_i = d_i^13 s_i + sum_t full_t d_i^(12-t).  A
// round's latency is lane 0's chain (S-box and one product), not a
// shuffle reduction; the price is about 100 more products a thread.
template <int G>
__device__ __forceinline__ void partial_rounds_fast(uint32_t s[], int q,
                                                    unsigned mask,
                                                    const Consts<G>& c) {
  constexpr int L = Group<G>::L;
  uint32_t p[N_PARTIAL];
#pragma unroll
  for (int k = 0; k < N_PARTIAL; ++k) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t t = k == 0 ? s[j] : bb::mul(s[j], c.dpow[j][k]);
      acc = bb::add(acc, (j == 0 && q == 0) ? 0u : t);   // not lane 0
    }
    p[k] = acc;
  }
#pragma unroll
  for (int d = 1; d < G; d <<= 1)
#pragma unroll
    for (int k = 0; k < N_PARTIAL; ++k)
      p[k] = bb::add(p[k], __shfl_xor_sync(mask, p[k], d, G));
  uint32_t x0 = __shfl_sync(mask, s[0], 0, G);   // lane 0
  uint32_t full[N_PARTIAL];
#pragma unroll
  for (int t = 0; t < N_PARTIAL; ++t) {
    uint32_t u = p[t];
#pragma unroll
    for (int j = 0; j < t; ++j) u = bb::add(u, bb::mul(full[t - 1 - j], DIAG_POW_SUMS[j]));
    const uint32_t y = sbox(bb::add(x0, INT_RC[t]));
    full[t] = bb::mul(bb::add(u, y), SCALE);
    x0 = bb::mul(bb::sub(u, y), SCALE);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint32_t v = bb::mul(s[j], c.dpow[j][N_PARTIAL]);
#pragma unroll
    for (int t = 0; t < N_PARTIAL; ++t)
      v = bb::add(v, t == N_PARTIAL - 1 ? full[t]
                                        : bb::mul(full[t], c.dpow[j][N_PARTIAL - 1 - t]));
    s[j] = (j == 0 && q == 0) ? x0 : v;
  }
}

// The permutation of the state held by this thread's group.  A group's
// rounds are unrolled (its constants are registers); a one-thread state
// keeps them as loops.
template <int G>
__device__ __forceinline__ void permute(uint32_t s[], int q, unsigned mask,
                                        const Consts<G>& c) {
  external_layer<G>(s, q, mask);
  if constexpr (G == 1) {
    for (int r = 0; r < HALF_FULL; ++r) full_round<G>(s, r, q, mask, c);
    for (int r = 0; r < N_PARTIAL; ++r) partial_round<G>(s, r, q, mask, c);
    for (int r = HALF_FULL; r < N_FULL; ++r) full_round<G>(s, r, q, mask, c);
  } else {
#pragma unroll
    for (int r = 0; r < HALF_FULL; ++r) full_round<G>(s, r, q, mask, c);
    if constexpr (G == SUBTREE_G) {
      partial_rounds_fast<G>(s, q, mask, c);
    } else {
#pragma unroll
      for (int r = 0; r < N_PARTIAL; ++r) partial_round<G>(s, r, q, mask, c);
    }
#pragma unroll
    for (int r = HALF_FULL; r < N_FULL; ++r) full_round<G>(s, r, q, mask, c);
  }
}

// This thread's group, its index q in the group and the group's shuffle
// mask.
template <int G>
struct Member {
  int64_t group;
  int q;
  unsigned mask;
  __device__ __forceinline__ explicit Member(int64_t thread) {
    group = thread / G;
    q = int(thread % G);
    const int lane = threadIdx.x % 32;
    mask = ((G == 32 ? 0u : (1u << G)) - 1) << (lane / G * G);
  }
};

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
  cudaMemcpyToSymbol(DIAG_POW_LANES, diag_pows,
                     sizeof(uint32_t) * WIDTH * (N_PARTIAL + 1));
  cudaMemcpyToSymbol(DIAG_POW_SUMS, diag_pow_sums, sizeof(uint32_t) * N_PARTIAL);
  cudaMemcpyToSymbol(EXT_RC, ext_rc, sizeof(uint32_t) * N_FULL * WIDTH);
  cudaMemcpyToSymbol(EXT_RC_LANES, ext_rc, sizeof(uint32_t) * N_FULL * WIDTH);
  cudaMemcpyToSymbol(INT_RC, int_rc, sizeof(uint32_t) * N_PARTIAL);
  cudaMemcpyToSymbol(SCALE, scale, sizeof(uint32_t));
  cudaMemcpyToSymbol(SCALED_DIAG, scaled_diag, sizeof(uint32_t) * WIDTH);
  cudaMemcpyToSymbol(SCALED_DIAG_LANES, scaled_diag, sizeof(uint32_t) * WIDTH);
  cudaMemcpyToSymbol(INT_RC_LANES, int_rc, sizeof(uint32_t) * N_PARTIAL);
  cudaMemcpyToSymbol(SCALE_LANES, scale, sizeof(uint32_t));
  return (int)cudaGetLastError();
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
