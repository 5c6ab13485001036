// The Poseidon width-12 permutation over Goldilocks, held by a group of G
// threads (G = 1, 2, 4 or 12): the round code that csrc/poseidon_gl.cu (the
// permutation, leaf sponge and Merkle kernels) and csrc/transcript.cu (the
// transcript step and the PoW grind) share.  Round schedule of the
// reference (4 full, 22 partial, 4 full rounds, x^7 S-box, MDS out[r] =
// sum_i CIRC[i] s[(i + r) % 12] + DIAG[r] s[r]), bit-exact with
// hash/poseidon_gl.py:permute_host.  The design notes are at the top of
// csrc/poseidon_gl.cu.
//
// Each library built from a source that includes this header (once) has its
// own copies of the constant tables (RC, RC2, RC_LANES) and fills them with
// set_constants before its first launch.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "gl.cuh"

namespace poseidon_gl {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int N_PARTIAL = 22;
constexpr int N_ROUNDS = 2 * HALF_FULL + N_PARTIAL;

// The MDS circulant and diagonal (reference poseidon_goldilocks.rs:301-302)
__host__ __device__ constexpr uint32_t circ(int i) {
  constexpr uint32_t CIRC[WIDTH] = {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20};
  return CIRC[i];
}
__host__ __device__ constexpr uint32_t diag(int i) {
  constexpr uint32_t DIAG[WIDTH] = {8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return DIAG[i];
}
static_assert(diag(1) == 0 && diag(11) == 0, "the MDS adds DIAG on lane 0 only");

__constant__ uint64_t RC[N_ROUNDS * WIDTH];

// G threads hold one state; lanes q + G j (j < L) live in thread q of the
// group.  A group spans SPAN consecutive threads of a warp.
template <int G>
struct Group {
  static_assert(WIDTH % G == 0, "G divides the width");
  static constexpr int L = WIDTH / G;
  static constexpr int SPAN = G == 12 ? 16 : G;
};

// An MDS input or output in three limbs of 22, 22 and 20 bits.
constexpr int LIMBS = 3;
constexpr uint32_t M22 = (1u << 22) - 1;

__host__ __device__ __forceinline__ uint32_t limb(uint64_t x, int t) {
  return t == 0 ? uint32_t(x) & M22
                : t == 1 ? uint32_t(x >> 22) & M22 : uint32_t(x >> 44);
}

// The round constants besides RC: twice their limbs by round, limb and
// lane, with a zero row after the last round (the last MDS adds none), for
// one-thread states (G = 1), which copy them to shared memory (an index
// that varies with the round would cost an LDC per word from constant
// memory); and a copy in global memory for G > 1, read per lane through
// the L1 cache (the constant cache serialises a warp's distinct addresses).
constexpr int RC2_WORDS = (N_ROUNDS + 1) * LIMBS * WIDTH;
__device__ uint4 RC2[RC2_WORDS / 4];
__device__ uint64_t RC_LANES[N_ROUNDS * WIDTH];

// G = 1: RC2 into this block's shared copy (call before any thread leaves).
template <int G>
__device__ __forceinline__ const uint32_t* rc2_to_shared(uint4* smem) {
  if constexpr (G == 1) {
    for (int i = threadIdx.x; i < RC2_WORDS / 4; i += blockDim.x)
      smem[i] = RC2[i];
    __syncthreads();
  }
  return reinterpret_cast<const uint32_t*>(smem);
}

// x + n2 2^64 (mod p) for n2 < 2^32, as some u64 congruent to it, not
// necessarily below p.  Each MDS output is left so: its consumers take any
// u64 (gl::mul reduces a whole 128-bit product, the next MDS splits it in
// limbs), and permute canonicalises the state once at its end.
__device__ __forceinline__ uint64_t fold(uint64_t x, uint64_t n2) {
  const uint64_t t = (n2 << 32) - n2;   // n2 2^64 = n2 (2^32 - 1) (mod p)
  const uint64_t y = x + t;
  return y < t ? y + gl::EPS : y;       // wrapped: y < t, so no second wrap
}

// 32-bit sums of limbs times CIRC: every product and every sum of the 14
// terms of a lane stays below 2^31, so each term is one 32-bit IMAD.
template <uint32_t C>
__device__ __forceinline__ void mac(uint32_t& acc, uint32_t x) {
  asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(acc) : "r"(x), "n"(C));
}

struct MdsAcc {            // value = a0 + a1 2^22 + a2 2^44
  uint32_t a0, a1, a2;
  __device__ __forceinline__ explicit MdsAcc(uint64_t rc)
      : a0(limb(rc, 0)), a1(limb(rc, 1)), a2(limb(rc, 2)) {}
  template <uint32_t C>
  __device__ __forceinline__ void add(uint64_t x) {
    mac<C>(a0, limb(x, 0));
    mac<C>(a1, limb(x, 1));
    mac<C>(a2, limb(x, 2));
  }
  __device__ __forceinline__ void add_rt(uint64_t x, uint32_t c) {
    a0 += limb(x, 0) * c;
    a1 += limb(x, 1) * c;
    a2 += limb(x, 2) * c;
  }
  __device__ __forceinline__ uint64_t reduce() const { return join(a0, a1, a2); }
  // a0 + a1 2^22 + a2 2^44 (mod p) for a_t < 2^31
  __device__ __forceinline__ static uint64_t join(uint32_t a0, uint32_t a1,
                                                 uint32_t a2) {
    const uint64_t v = a0 + (uint64_t(a1) << 22);      // < 2^54
    const uint64_t x = v + (uint64_t(a2) << 44);       // mod 2^64
    return fold(x, (a2 >> 20) + (x < v));
  }
};

template <int OFF, int K = 0>
__device__ __forceinline__ void mds_terms(MdsAcc& acc,
                                          const uint64_t rel[WIDTH]) {
  if constexpr (K < WIDTH) {
    acc.add<circ(K)>(rel[(K + OFF) % WIDTH]);
    mds_terms<OFF, K + 1>(acc, rel);
  }
}

// MDS output lane q + OFF, where rel[k] is state lane (q + k) % 12:
// sum_k CIRC[k] rel[(k + OFF) % 12] (+ d0 rel[0], d0 = DIAG[0] on lane 0)
// + fc fix + rc; fix is the change of lane 0 that rel does not hold yet.
template <int OFF, bool FIX>
__device__ __forceinline__ uint64_t mds_lane(const uint64_t rel[WIDTH],
                                             uint32_t d0, uint64_t rc,
                                             uint64_t fix, uint32_t fc) {
  MdsAcc acc(rc);
  mds_terms<OFF>(acc, rel);
  if (OFF == 0) acc.add_rt(rel[0], d0);
  if (FIX) acc.add_rt(fix, fc);
  return acc.reduce();
}

template <int G, bool FIX, int J = 0>
__device__ __forceinline__ void mds_lanes(uint64_t s[], const uint64_t rel[],
                                          int q, const uint64_t* rc,
                                          uint64_t fix, const uint32_t* fc) {
  if constexpr (J < Group<G>::L) {
    const int r = q + G * J;
    s[J] = mds_lane<(G * J) % WIDTH, FIX>(
        rel, J == 0 && q == 0 ? diag(0) : 0, rc ? __ldg(rc + r) : 0, fix,
        FIX ? fc[J] : 0);
    mds_lanes<G, FIX, J + 1>(s, rel, q, rc, fix, fc);
  }
}

// The MDS of a whole state in one thread (G = 1), per limb plane, by two
// CRT splits of the circulant.  With u = x[:6] + x[6:] and v = x[:6] -
// x[6:], out[r] + out[r+6] is a cyclic correlation of u with U[k] = C[k] +
// C[k+6] and out[r] - out[r+6] a negacyclic one of v with V[k] = C[k] -
// C[k+6]; the cyclic one splits again over halves of 3 (U2, V2).  Every
// coefficient of V, U2 and V2 is a power of two, so each term is a shift
// and an add.  Sums wrap mod 2^32; each halving is of an even number
// below 2^32, so it is exact.
__host__ __device__ constexpr uint32_t crt_u(int k) { return circ(k) + circ(k + 6); }
__host__ __device__ constexpr uint32_t crt_v(int k) { return circ(k) - circ(k + 6); }
__host__ __device__ constexpr uint32_t crt_u2(int k) { return crt_u(k) + crt_u(k + 3); }
__host__ __device__ constexpr uint32_t crt_v2(int k) { return crt_u(k) - crt_u(k + 3); }

// out[r] = sum_j C[(j - r) mod 12] x[j] + seed2[r] / 2 for one limb plane;
// seed2 holds twice the seeds (the halvings take them in whole).
__device__ __forceinline__ void mds_plane(const uint32_t x[WIDTH],
                                          const uint32_t seed2[WIDTH],
                                          uint32_t out[WIDTH]) {
  uint32_t u[6], v[6], p[3], m[3], a[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    u[j] = x[j] + x[j + 6];
    v[j] = x[j] - x[j + 6];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p[j] = u[j] + u[j + 3];
    m[j] = u[j] - u[j + 3];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    uint32_t sa = 0, sb = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sa += crt_u2((j - r + 3) % 3) * p[j];
      sb += (j >= r ? crt_v2(j - r) : 0u - crt_v2(j - r + 3)) * m[j];
    }
    a[r] = (sa + sb) >> 1;
    a[r + 3] = (sa - sb) >> 1;
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    uint32_t b = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j)
      b += (j >= r ? crt_v(j - r) : 0u - crt_v(j - r + 6)) * v[j];
    out[r] = (a[r] + b + seed2[r]) >> 1;
    out[r + 6] = (a[r] - b + seed2[r + 6]) >> 1;
  }
}

// s <- MDS(s) + the constants whose doubled limbs rc2 holds (a row of RC2).
__device__ __forceinline__ void mds_whole(uint64_t s[WIDTH],
                                          const uint32_t* rc2) {
  uint32_t y[LIMBS][WIDTH];
#pragma unroll
  for (int t = 0; t < LIMBS; ++t) {
    uint32_t x[WIDTH], seed2[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      x[i] = limb(s[i], t);
      seed2[i] = rc2[t * WIDTH + i];
    }
    seed2[0] += 2 * diag(0) * x[0];
    mds_plane(x, seed2, y[t]);
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = MdsAcc::join(y[0][i], y[1][i], y[2][i]);
}

// s <- MDS(s) + the constants of round `next` (none for N_ROUNDS; G = 1
// reads them from rc2, the shared copy of RC2); with
// FIX, lane 0 is taken as lane 0 + fix, fc[j] being lane 0's coefficient
// in this thread's output lane q + G j.
template <int G, bool FIX = false>
__device__ __forceinline__ void mds(uint64_t s[], int q, unsigned mask,
                                    const uint32_t* rc2, int next,
                                    uint64_t fix = 0,
                                    const uint32_t* fc = nullptr) {
  constexpr int L = Group<G>::L, SPAN = Group<G>::SPAN;
  if constexpr (G == 1) {
    mds_whole(s, rc2 + next * LIMBS * WIDTH);
  } else {
    uint64_t rel[WIDTH];  // rel[k] = lane (q + k) % 12
#pragma unroll
    for (int u = 0; u < G; ++u) {
      // thread (q + u) % G holds lanes (q + u) % G + G j'; read as offsets
      // from q they are u + G (j' - c), c = 1 where q + u wrapped past G
      const int src = q + u < G ? q + u : q + u - G;
      uint64_t got[L];
#pragma unroll
      for (int j = 0; j < L; ++j) got[j] = __shfl_sync(mask, s[j], src, SPAN);
      const bool c = q + u >= G;
#pragma unroll
      for (int j = 0; j < L; ++j) rel[u + G * j] = c ? got[(j + 1) % L] : got[j];
    }
    mds_lanes<G, FIX>(s, rel, q,
                      next < N_ROUNDS ? RC_LANES + next * WIDTH : nullptr,
                      fix, fc);
  }
}

template <int G>
__device__ __forceinline__ void sbox_all(uint64_t s[]) {
#pragma unroll
  for (int j = 0; j < Group<G>::L; ++j) s[j] = gl::sbox(s[j]);
}

// The permutation of the state held by this thread's group.
template <int G>
__device__ __forceinline__ void permute(uint64_t s[], int q, unsigned mask,
                                        const uint32_t* rc2) {
  constexpr int L = Group<G>::L, SPAN = Group<G>::SPAN;
#pragma unroll
  for (int j = 0; j < L; ++j)
    s[j] = gl::add(s[j], G == 1 ? RC[j] : __ldg(RC_LANES + q + G * j));
  // Lane 0's coefficient in each output lane of this thread (G > 1): the
  // partial rounds apply lane 0's S-box as a correction of the MDS, so the
  // S-box and the rest of the MDS do not wait on each other.
  uint32_t fc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int r = q + G * j;
    fc[j] = r == 0 ? circ(0) + diag(0) : 0;
#pragma unroll
    for (int i = 1; i < WIDTH; ++i)
      if (r == WIDTH - i) fc[j] = circ(i);
  }
  // the round loops stay loops (4, 22, 4 trips): the SASS reader of
  // probes.py counts a permutation from them
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) {
    sbox_all<G>(s);
    mds<G>(s, q, mask, rc2, r + 1);
  }
#pragma unroll 1
  for (int r = HALF_FULL; r < HALF_FULL + N_PARTIAL; ++r) {
    if constexpr (G == 1) {
      s[0] = gl::sbox(s[0]);
      mds<G>(s, q, mask, rc2, r + 1);
    } else {   // every thread of the group: lane 0 (slot 0 of thread 0)
      const uint64_t x0 = gl::canon(__shfl_sync(mask, s[0], 0, SPAN));
      mds<G, true>(s, q, mask, rc2, r + 1, gl::sub(gl::sbox(x0), x0), fc);
    }
  }
#pragma unroll 1
  for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) {
    sbox_all<G>(s);
    mds<G>(s, q, mask, rc2, r + 1);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = gl::canon(s[j]);
}

// This thread's group, its index q in the group and the shuffle mask of
// the group.  A spare thread of a 16-thread group (q >= 12) computes lanes
// of q - 12 as a copy and never writes them.
template <int G>
struct Member {
  int64_t group;
  int q;
  bool spare;
  unsigned mask;
  __device__ __forceinline__ Member(int64_t thread) {
    constexpr int SPAN = Group<G>::SPAN;
    group = thread / SPAN;
    const int t = int(thread % SPAN);
    spare = t >= G;
    q = spare ? t - G : t;
    const int lane = threadIdx.x % 32;
    mask = SPAN == 32 ? 0xffffffffu
                      : ((1u << SPAN) - 1) << (lane / SPAN * SPAN);
  }
};

// The round constants (N_ROUNDS x WIDTH, reference order) into this
// translation unit's copies: RC, RC_LANES and the doubled limbs RC2.
inline int set_constants(const uint64_t* rc) {
  alignas(16) uint32_t rc2[RC2_WORDS] = {};
  for (int i = 0; i < N_ROUNDS * LIMBS * WIDTH; ++i)
    rc2[i] = 2 * limb(rc[i / (LIMBS * WIDTH) * WIDTH + i % WIDTH],
                      i / WIDTH % LIMBS);
  cudaMemcpyToSymbol(RC, rc, sizeof(uint64_t) * N_ROUNDS * WIDTH);
  cudaMemcpyToSymbol(RC_LANES, rc, sizeof(uint64_t) * N_ROUNDS * WIDTH);
  cudaMemcpyToSymbol(RC2, rc2, sizeof(rc2));
  return (int)cudaGetLastError();
}

}  // namespace poseidon_gl
