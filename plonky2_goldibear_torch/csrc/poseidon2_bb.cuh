// The Poseidon2 width-16 permutation over BabyBear, held by a group of G
// threads (G = 1, 4 or 16): the round code that csrc/poseidon2_bb.cu (the
// permutation, leaf sponge and Merkle kernels) and csrc/transcript.cu (the
// transcript step and the PoW grind) share.  The reference's round schedule
// (gates/poseidon2_babybear.rs:700-995), bit-exact with
// hash/poseidon2_bb.py:permute_host; values and constants are Montgomery
// forms (bb.cuh).  The design notes are at the top of csrc/poseidon2_bb.cu.
//
// Each library built from a source that includes this header (once) has its
// own copies of the constant tables and fills them with set_constants before
// its first launch.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "bb.cuh"

namespace poseidon2_bb {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int N_FULL = 8;
constexpr int N_PARTIAL = 13;
constexpr int SUBTREE_G = 16;           // threads per parent in a subtree:
                                        // the group of partial_rounds_fast

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

// The constants (see poseidon2_bb_set_constants in csrc/poseidon2_bb.cu)
// into this translation unit's copies.
inline int set_constants(const uint32_t* ext_rc, const uint32_t* int_rc,
                         const uint32_t* scale, const uint32_t* scaled_diag,
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

}  // namespace poseidon2_bb
