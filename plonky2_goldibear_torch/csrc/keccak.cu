// Keccak-f[1600] and the three hashing entry points of the Keccak
// configuration (the reference's KeccakHash<25>, plonky2/src/hash/
// keccak.rs:14-126): Keccak-256 with the original 0x01 ... 0x80 padding
// and a rate of 136 bytes, its first 25 bytes kept as a digest.
//
//   keccak_rows           the digest of each of n rows of L bytes: the leaf
//                         hashes (Goldilocks rows viewed as their bytes)
//   keccak_merkle_run     the Merkle levels down to the cap, as a list of
//                         launches (ops/keccak.py:merkle_plan): one level
//                         launch a level, then one subtree launch for the
//                         narrow top levels; a dense level of m digests is
//                         m / 2 rows of 50 bytes, because siblings are
//                         adjacent
//   keccak_permute        the hash-onion over 12 Goldilocks elements with
//                         rejection sampling into the field (keccak.rs:63-98)
//
// Replaces no Pallas kernel: the JAX package computes Keccak in jnp
// (plonky2_goldibear_tpu/hash/keccak_device.py:keccak_f, a lax.scan over
// the 24 rounds on (lo, hi) u32 lane planes), which in plain torch would be
// some 5,000 elementwise launches a Keccak-f.  The plain torch twin is
// hash/keccak_device.py.
//
// Bound on the H100: 32-bit integer instructions.  A Keccak-f is at least
// 180 32-bit operations a round on the lanes' halves with three-input
// logic ops (theta 80, rho 48, chi 50, iota 2), 4,320 in all, against at
// most 136 bytes read and 25 written a block; so a launch that fills the
// card is bound by its instructions, and one that does not (a Merkle
// level of a few thousand parents or fewer, the FRI layers' rows) by one
// Keccak-f's latency: a lone warp issues an integer instruction every 2
// clocks at best, so one thread's 4,776 instructions take ~5 us.  Design:
//   * A state is held by a group of G threads, G = 1 or 25, chosen per
//     launch by ops/keccak.py (group_for, launch_plan, merkle_plan).  G = 1
//     keeps the 25 lanes in registers, the round's steps unrolled, chi
//     left to the compiler's three-input logic ops: the fewest
//     instructions a state, for launches that fill the card (the 2^15-row
//     leaves, the wide Merkle levels, the hash-onion): a round is 136 LOP3
//     and 58 SHF, all on the ALU pipe, which a warp alone feeds at one
//     instruction every 2 clocks, so a lone Keccak-f takes ~5 us.
//   * G = 25 (a lane a thread, threads 0 to 24 of a warp) cuts the latency
//     of a Keccak-f for the narrow launches: each round the warp writes
//     its lanes to its shared-memory scratch, each thread reads the two
//     columns beside its own for theta, rotates its lane by its rho offset
//     (per-thread: two selects and two funnel shifts), writes it to its pi
//     place and reads its chi row neighbours back; two __syncwarp a round,
//     ~50 instructions a thread-round against 199.  It costs ~6x the
//     instructions of G = 1 a state, so it pays only where the launch
//     leaves the card's issue slots idle.  The keccak_groups sweep
//     (probes.py) measured the alternatives and dropped them: 5 threads a
//     state (a column each, through shared memory) was slower than one
//     thread at every width; 25 threads exchanging lanes by warp shuffles
//     (theta's ten pulls, then pi and chi's three) took 8.1 us a
//     16-parent level, and 25 threads with one __syncwarp a round (each
//     thread reading all 25 lanes by column and its three pi sources) 9.5,
//     against 5.9 here and 7.5 at one thread.
//   * Merkle pairs are read as the 32-bit words that hold them and
//     funnel-shifted into lanes (a 50-byte pair at an even address is 13
//     words), not byte by byte; digests go out through shared memory,
//     coalesced (a warp a digest).  A whole tree is one host call over the
//     plan's launches.  Each launch costs the host ~6 us on the H100's
//     machine, more than a narrow level's 5.5-6.5 us on the card, so the
//     top levels that take 25 threads a state, SUBTREE_MAX_LAYERS at
//     most, run as one subtree launch, a block a subtree (for a cap of
//     16, a block a cap node): the subtree's digests are staged into shared memory by
//     coalesced word loads, held there as 32-byte slots, and each level is
//     one Keccak-f's latency and a block barrier.  On the card alone that
//     is ~3 us slower a tree than level launches; with the host's time it
//     is 16-28 us faster at 2^15 and 2^11 leaves (kernel_times.py
//     --keccak, with and without --graphs; PERF.md).
//   * Rows are read a 64-bit lane at a time where the row length is a
//     multiple of 8 bytes, else byte by byte; a group's threads each read
//     their own lanes.  The hash-onion keeps one thread a state (it fills
//     the card at the grind's 2^17 states).
#include <cstdint>
#include <cuda_runtime.h>

#ifndef ONION_TEST_HOOK
#define ONION_TEST_HOOK(s)
#endif

namespace {

constexpr int RATE_BYTES = 136;
constexpr int RATE_LANES = 17;
constexpr int DIGEST = 25;            // bytes of a digest (HASH_SIZE)
constexpr int ONION_WIDTH = 12;       // Goldilocks elements of a state
constexpr int THREADS = 128;          // the hash-onion's block
constexpr int MAX_THREADS = 256;      // the most a rows or level block takes
constexpr int SUBTREE_MAX_LAYERS = 4; // 16 digests at a subtree's bottom
constexpr int SUB_MAX = 1 << SUBTREE_MAX_LAYERS;
constexpr uint64_t GL_P = 0xFFFFFFFF00000001ull;
constexpr uint64_t PAD_LAST = 0x8000000000000000ull;

__constant__ uint64_t RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

// rho's rotation of lane j = x + 5 y
__constant__ int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

// rotate left by a constant: two funnel shifts on the halves.  (Three
// IMADs by a power of two read from constant memory, to move the rotates
// to the multiply pipe beside the ALU's logic ops, made a lone thread's
// Keccak-f 1.6x slower on the H100: the keccak_groups sweep, 7.4 -> 12.1
// us a 16-parent level.)
template <int R>
__device__ __forceinline__ uint64_t rotl(uint64_t x) {
  if constexpr (R % 64 == 0) {
    return x;
  } else {
    uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
    if constexpr (R >= 32) {
      const uint32_t t = lo;
      lo = hi;
      hi = t;
    }
    constexpr int r = R & 31;
    if constexpr (r == 0) {
      return ((uint64_t)hi << 32) | lo;
    } else {
      const uint32_t nhi = __funnelshift_l(lo, hi, r);
      const uint32_t nlo = __funnelshift_l(hi, lo, r);
      return ((uint64_t)nhi << 32) | nlo;
    }
  }
}

// rotate left by r (0 to 63) held in a register
__device__ __forceinline__ uint64_t rotl_var(uint64_t x, int r) {
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  const bool swap = r & 32;
  const uint32_t a = swap ? hi : lo, b = swap ? lo : hi;
  const uint32_t nhi = __funnelshift_l(a, b, r);   // the shift wraps mod 32
  const uint32_t nlo = __funnelshift_l(b, a, r);
  return ((uint64_t)nhi << 32) | nlo;
}

// Keccak-f[1600] on 25 lanes in one thread's registers
__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
    }
    // rho and pi: b[y + 5 ((2x + 3y) % 5)] = rotl(a[x + 5y], rot[x][y])
    b[0] = a[0];
    b[16] = rotl<36>(a[5]);
    b[7] = rotl<3>(a[10]);
    b[23] = rotl<41>(a[15]);
    b[14] = rotl<18>(a[20]);
    b[10] = rotl<1>(a[1]);
    b[1] = rotl<44>(a[6]);
    b[17] = rotl<10>(a[11]);
    b[8] = rotl<45>(a[16]);
    b[24] = rotl<2>(a[21]);
    b[20] = rotl<62>(a[2]);
    b[11] = rotl<6>(a[7]);
    b[2] = rotl<43>(a[12]);
    b[18] = rotl<15>(a[17]);
    b[9] = rotl<61>(a[22]);
    b[5] = rotl<28>(a[3]);
    b[21] = rotl<55>(a[8]);
    b[12] = rotl<25>(a[13]);
    b[3] = rotl<21>(a[18]);
    b[19] = rotl<56>(a[23]);
    b[15] = rotl<27>(a[4]);
    b[6] = rotl<20>(a[9]);
    b[22] = rotl<39>(a[14]);
    b[13] = rotl<8>(a[19]);
    b[4] = rotl<14>(a[24]);
    // chi, then iota
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    }
    a[0] ^= RC[round];
  }
}

// -- groups ---------------------------------------------------------------

// A thread's place among the groups of G threads (1 or 25) that hold a
// state: 32 / G groups a warp, the state's lane j = q + G i in the
// thread's s[i] (G = 25: lane q, threads 25 to 31 of the warp spare).
template <int G>
struct Member {
  static constexpr int PER_WARP = 32 / G;
  static constexpr int PER_BLOCK = MAX_THREADS / 32 * PER_WARP;
  int q;             // the thread's index in its group
  int local;         // the group's index in its block
  int64_t group;     // the group's index in the grid
  unsigned mask;     // the group's threads in their warp
  bool spare;
  __device__ __forceinline__ Member(int thread, int64_t first_group) {
    const int lane = thread & 31, gw = lane / G;
    q = lane - gw * G;
    spare = gw >= PER_WARP;
    local = (thread >> 5) * PER_WARP + gw;
    group = first_group + local;
    mask = ((1u << G) - 1u) << (gw * G);
  }
};

// The constants of the thread that holds lane q = x + 5 y of a 25-thread
// group: theta's columns x - 1 and x + 1, rho's offset, pi's place, and
// chi's row neighbours x + 1 and x + 2
template <int G>
struct Geometry {
  __device__ __forceinline__ explicit Geometry(int) {}
};

template <>
struct Geometry<25> {
  int xm, xp, rot, dst, n1, n2;
  __device__ __forceinline__ explicit Geometry(int q) {
    const int x = q % 5, y = q / 5;
    xm = (x + 4) % 5;
    xp = (x + 1) % 5;
    rot = ROT[q];
    dst = y + 5 * ((2 * x + 3 * y) % 5);
    n1 = 5 * y + (x + 1) % 5;
    n2 = 5 * y + (x + 2) % 5;
  }
};

// Keccak-f[1600] on a state held by 25 threads of one warp, a lane each,
// through the warp's scratch buf (A: buf[0, 25), B: buf[25, 50)).  Two
// __syncwarp a round: A is rewritten only after every thread has read it
// for theta (they have passed the second barrier), B only after every
// thread has read it for chi (they have passed the first).
__device__ __forceinline__ void keccak_f_lanes(uint64_t& a, int q,
                                               unsigned mask, uint64_t* buf,
                                               const Geometry<25>& geo) {
  uint64_t* A = buf;
  uint64_t* B = buf + 25;
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    A[q] = a;
    __syncwarp(mask);
    const int xm = geo.xm, xp = geo.xp;
    const uint64_t cm = A[xm] ^ A[xm + 5] ^ A[xm + 10] ^ A[xm + 15] ^
                        A[xm + 20];
    const uint64_t cp = A[xp] ^ A[xp + 5] ^ A[xp + 10] ^ A[xp + 15] ^
                        A[xp + 20];
    B[geo.dst] = rotl_var(a ^ cm ^ rotl<1>(cp), geo.rot);
    __syncwarp(mask);
    a = B[q] ^ (~B[geo.n1] & B[geo.n2]);
    if (q == 0) a ^= RC[round];
  }
}

// a warp's scratch for a 25-thread group: two 25-lane buffers
constexpr int WARP_BUF = 50;

template <int G>
__device__ __forceinline__ void keccak_f_any(uint64_t s[], const Member<G>& m,
                                             uint64_t* buf,
                                             const Geometry<G>& geo) {
  if constexpr (G == 1)
    keccak_f(s);
  else
    keccak_f_lanes(s[0], m.q, m.mask, buf, geo);
}

// the calling warp's scratch in a block's pool (one word for G = 1)
template <int G>
__device__ __forceinline__ uint64_t* warp_scratch(uint64_t* pool) {
  return G == 1 ? pool : pool + (threadIdx.x >> 5) * WARP_BUF;
}

// -- loads and stores -------------------------------------------------------

// the little-endian bytes p[0 .. k) as a lane, k < 8
__device__ __forceinline__ uint64_t load_partial(const uint8_t* p, int k) {
  uint64_t v = 0;
  for (int i = 0; i < k; ++i) v |= (uint64_t)p[i] << (8 * i);
  return v;
}

template <bool ALIGNED>
__device__ __forceinline__ uint64_t load_lane(const uint8_t* p) {
  if constexpr (ALIGNED) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
  } else {
    uint64_t v = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) v |= (uint64_t)__ldg(p + i) << (8 * i);
    return v;
  }
}

// Keccak-256 of the len bytes at p, into a state held by m's group.
// ALIGNED: p and len are multiples of 8 bytes.
template <int G, bool ALIGNED>
__device__ __forceinline__ void absorb(const uint8_t* p, int len,
                                       uint64_t s[], const Member<G>& m,
                                       uint64_t* buf, const Geometry<G>& geo) {
  constexpr int L = 25 / G;
#pragma unroll
  for (int i = 0; i < L; ++i) s[i] = 0;
  int off = 0;
  for (; len - off >= RATE_BYTES; off += RATE_BYTES) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int j = m.q + G * i;
      if (j < RATE_LANES) s[i] ^= load_lane<ALIGNED>(p + off + 8 * j);
    }
    keccak_f_any<G>(s, m, buf, geo);
  }
  // the last block: the rem bytes left, 0x01 after them, 0x80 at its end
  const int rem = len - off;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int j = m.q + G * i, b0 = 8 * j;
    if (j >= RATE_LANES) continue;
    uint64_t v = 0;
    if (b0 + 8 <= rem)
      v = load_lane<ALIGNED>(p + off + b0);
    else if (b0 < rem)
      v = load_partial(p + off + b0, rem - b0);
    if (b0 <= rem && rem < b0 + 8) v ^= 1ull << (8 * (rem - b0));
    if (j == RATE_LANES - 1) v ^= PAD_LAST;
    s[i] ^= v;
  }
  keccak_f_any<G>(s, m, buf, geo);
}

// `count` digests of out_bytes (<= 32) bytes from their 32-byte slots to
// out, back to back: a warp a digest, its lanes on its bytes.
__device__ __forceinline__ void write_slots(const uint64_t (*slots)[4],
                                            int64_t count, uint8_t* out,
                                            int out_bytes) {
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(slots);
  const int lane = threadIdx.x & 31;
  if (lane < out_bytes)
    for (int64_t d = threadIdx.x >> 5; d < count; d += blockDim.x >> 5)
      out[d * out_bytes + lane] = sb[32 * d + lane];
}

// The first out_bytes (<= 32) bytes of each active group's hash (lanes 0
// to 3, from the threads that hold them) into its 32-byte slot, then the
// block's `count` digests written out together, consecutive threads on
// consecutive bytes (write_slots): a thread's own 25 bytes at a 25-byte
// stride would touch 25 sectors a warp store.  Every thread of the block
// calls it.
template <int G>
__device__ __forceinline__ void store_digests(const uint64_t s[],
                                              const Member<G>& m, bool active,
                                              uint64_t (*slots)[4],
                                              uint8_t* out, int64_t count,
                                              int out_bytes) {
  if (active) {
#pragma unroll
    for (int i = 0; i < 25 / G; ++i) {
      const int j = m.q + G * i;
      if (j < 4) slots[m.local][j] = s[i];
    }
  }
  __syncthreads();
  write_slots(slots, count, out, out_bytes);
}

// lane j of the 50-byte message left || right with its padding, the
// digests as 32-byte slots (lane 3 holds byte 24 alone)
__device__ __forceinline__ uint64_t pair_lane(const uint64_t* l,
                                              const uint64_t* r, int j) {
  switch (j) {
    case 0: return l[0];
    case 1: return l[1];
    case 2: return l[2];
    case 3: return l[3] | (r[0] << 8);
    case 4: return (r[0] >> 56) | (r[1] << 8);
    case 5: return (r[1] >> 56) | (r[2] << 8);
    case 6: return (r[2] >> 56) | (r[3] << 8) | (1ull << 16);
    case RATE_LANES - 1: return PAD_LAST;
  }
  return 0;
}

// lane j of the 50-byte message at p with its padding, from the 32-bit
// words that hold it (none past the message's last word)
__device__ __forceinline__ uint64_t pair_lane_global(const uint8_t* p, int j) {
  if (j == RATE_LANES - 1) return PAD_LAST;
  if (j > 6) return 0;
  const int sh = int((uintptr_t)p & 3) * 8;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(
      (uintptr_t)(p + 8 * j) & ~(uintptr_t)3);
  const uint32_t w0 = __ldg(w);
  if (j == 6) {    // bytes 48 and 49, then the 0x01
    const uint32_t w1 = sh > 16 ? __ldg(w + 1) : 0u;
    return (uint64_t)(__funnelshift_r(w0, w1, sh) & 0xFFFFu) | (1ull << 16);
  }
  const uint32_t w1 = __ldg(w + 1), w2 = sh ? __ldg(w + 2) : 0u;
  return ((uint64_t)__funnelshift_r(w1, w2, sh) << 32) |
         __funnelshift_r(w0, w1, sh);
}

// -- kernels ----------------------------------------------------------------

// the digest of each row, one row a group; every thread reaches the
// block barrier of the stores
template <int G, bool ALIGNED>
__global__ void __launch_bounds__(MAX_THREADS)
rows_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            int64_t n, int len, int out_bytes) {
  __shared__ uint64_t pool[G == 1 ? 1 : MAX_THREADS / 32 * WARP_BUF];
  __shared__ uint64_t slots[Member<G>::PER_BLOCK][4];
  const int64_t per_block = (blockDim.x >> 5) * Member<G>::PER_WARP;
  const int64_t first = int64_t(blockIdx.x) * per_block;
  const Member<G> m(threadIdx.x, first);
  const bool active = !m.spare && m.group < n;   // whole groups alike
  const Geometry<G> geo(m.q);
  uint64_t s[25 / G];
  if (active)
    absorb<G, ALIGNED>(in + m.group * len, len, s, m, warp_scratch<G>(pool),
                       geo);
  store_digests<G>(s, m, active, slots, out + first * out_bytes,
                   n - first < per_block ? n - first : per_block, out_bytes);
}

// one Merkle level: digests (2 parents, 25) -> parents (parents, 25), one
// parent a group
template <int G>
__global__ void __launch_bounds__(MAX_THREADS)
level_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
             int64_t parents) {
  __shared__ uint64_t pool[G == 1 ? 1 : MAX_THREADS / 32 * WARP_BUF];
  __shared__ uint64_t slots[Member<G>::PER_BLOCK][4];
  const int64_t per_block = (blockDim.x >> 5) * Member<G>::PER_WARP;
  const int64_t first = int64_t(blockIdx.x) * per_block;
  const Member<G> m(threadIdx.x, first);
  const bool active = !m.spare && m.group < parents;
  const Geometry<G> geo(m.q);
  uint64_t s[25 / G];
  if (active) {
    const uint8_t* p = in + m.group * (2 * DIGEST);
#pragma unroll
    for (int i = 0; i < 25 / G; ++i) s[i] = pair_lane_global(p, m.q + G * i);
    keccak_f_any<G>(s, m, warp_scratch<G>(pool), geo);
  }
  store_digests<G>(s, m, active, slots, out + first * DIGEST,
                   parents - first < per_block ? parents - first : per_block,
                   DIGEST);
}

// num_layers levels above digests (width, 25) as width >> num_layers
// independent subtrees, one block each, 25 threads a state (a warp a
// parent at the first level): the tail of a tree, one block per cap node.
// Level k (width >> (k + 1) digests) is written to out in natural order,
// levels back to back; block b writes its slice of each.  Every thread
// reaches every barrier.
__global__ void __launch_bounds__(SUB_MAX / 2 * 32)
subtree_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               int64_t width, int num_layers) {
  __shared__ uint64_t slots[2][SUB_MAX][4];
  __shared__ uint32_t raw[SUB_MAX * DIGEST / 4 + 4];
  __shared__ uint64_t pool[SUB_MAX / 2 * WARP_BUF];
  const int sub = 1 << num_layers;           // digests of one subtree
  // the subtree's sub * 25 bytes, as the aligned words that hold them
  const uint8_t* src = in + int64_t(blockIdx.x) * sub * DIGEST;
  const int head = int((uintptr_t)src & 3);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(src - head);
  const int nwords = (head + sub * DIGEST + 3) >> 2;
  for (int e = threadIdx.x; e < nwords + 2; e += blockDim.x)
    raw[e] = e < nwords ? __ldg(words + e) : 0u;
  __syncthreads();
  for (int e = threadIdx.x; e < sub * 4; e += blockDim.x) {
    const int d = e >> 2, k = e & 3;
    const int off = head + d * DIGEST + 8 * k, wi = off >> 2;
    const int sh = (off & 3) * 8;
    const uint64_t v =
        ((uint64_t)__funnelshift_r(raw[wi + 1], raw[wi + 2], sh) << 32) |
        __funnelshift_r(raw[wi], raw[wi + 1], sh);
    slots[0][d][k] = k == 3 ? v & 0xFF : v;
  }
  __syncthreads();
  const Member<25> m(threadIdx.x, 0);
  const Geometry<25> geo(m.q);
  int cur = 0;
  int64_t off = 0;       // the level's first digest in out
  int64_t w = width;     // the level's input width
  for (int layer = 0, parents = sub >> 1; layer < num_layers;
       ++layer, parents >>= 1) {
    if (!m.spare && m.group < parents) {
      uint64_t a = pair_lane(slots[cur][2 * m.group],
                             slots[cur][2 * m.group + 1], m.q);
      keccak_f_lanes(a, m.q, m.mask, warp_scratch<25>(pool), geo);
      if (m.q < 4) slots[cur ^ 1][m.group][m.q] = m.q == 3 ? a & 0xFF : a;
    }
    __syncthreads();
    write_slots(slots[cur ^ 1], parents,
                out + (off + int64_t(blockIdx.x) * parents) * DIGEST, DIGEST);
    off += w >> 1;
    w >>= 1;
    cur ^= 1;
  }
}

// One state of the hash-onion: hash the 12 lanes (96 bytes), then each
// 32-byte hash again, taking every word below p until 12 are taken.
__device__ __forceinline__ void onion(const uint64_t* in, uint64_t* out) {
  uint64_t s[25];
#pragma unroll
  for (int j = 0; j < 25; ++j) s[j] = j < ONION_WIDTH ? in[j] : 0;
  s[ONION_WIDTH] = 1;
  s[RATE_LANES - 1] = PAD_LAST;
  int k = 0;
  while (true) {
    keccak_f(s);
    ONION_TEST_HOOK(s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (s[i] < GL_P && k < ONION_WIDTH) out[k++] = s[i];
    if (k == ONION_WIDTH) return;
#pragma unroll
    for (int j = 4; j < 25; ++j) s[j] = 0;
    s[4] = 1;
    s[RATE_LANES - 1] = PAD_LAST;
  }
}

__global__ void __launch_bounds__(THREADS)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  onion(in + i * ONION_WIDTH, out + i * ONION_WIDTH);
}

// blocks of `threads` for n groups of G
template <int G>
unsigned blocks_for(int64_t n, int threads) {
  const int64_t per_block = int64_t(threads >> 5) * Member<G>::PER_WARP;
  return unsigned((n + per_block - 1) / per_block);
}

bool valid_block(int threads) {
  return threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0;
}

template <int G>
int launch_rows(const uint8_t* in, uint8_t* out, int64_t n, int len,
                int out_bytes, bool aligned, int threads, cudaStream_t st) {
  if (aligned)
    rows_kernel<G, true><<<blocks_for<G>(n, threads), threads, 0, st>>>(
        in, out, n, len, out_bytes);
  else
    rows_kernel<G, false><<<blocks_for<G>(n, threads), threads, 0, st>>>(
        in, out, n, len, out_bytes);
  return (int)cudaGetLastError();
}

template <int G>
int launch_level(const uint8_t* in, uint8_t* out, int64_t parents,
                 int threads, cudaStream_t st) {
  level_kernel<G><<<blocks_for<G>(parents, threads), threads, 0, st>>>(
      in, out, parents);
  return (int)cudaGetLastError();
}

// a subtree block: a warp a parent of its first level
int subtree(const uint8_t* in, uint8_t* out, int64_t width, int num_layers,
            cudaStream_t st) {
  if (num_layers < 1 || num_layers > SUBTREE_MAX_LAYERS ||
      width < (int64_t(1) << num_layers))
    return (int)cudaErrorInvalidValue;
  subtree_kernel<<<unsigned(width >> num_layers), 32 << (num_layers - 1), 0,
                   st>>>(in, out, width, num_layers);
  return (int)cudaGetLastError();
}

int level(const uint8_t* in, uint8_t* out, int64_t parents, int group,
          int threads, cudaStream_t st) {
  if (parents <= 0) return 0;
  if (!valid_block(threads)) return (int)cudaErrorInvalidValue;
  switch (group) {
    case 1: return launch_level<1>(in, out, parents, threads, st);
    case 25: return launch_level<25>(in, out, parents, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int keccak_max_threads() { return MAX_THREADS; }
extern "C" int keccak_subtree_max_layers() { return SUBTREE_MAX_LAYERS; }

// n rows of len bytes -> n digests of out_bytes (1 to 32) bytes, a row a
// group of `group` threads (1 or 25), `threads` a block (32 to 256, a
// multiple of 32).  aligned: in and len are multiples of 8 bytes.
extern "C" int keccak_rows(const uint8_t* in, uint8_t* out, long long n,
                           int len, int out_bytes, int aligned, int group,
                           int threads, void* stream) {
  if (len < 0 || out_bytes < 1 || out_bytes > 32 || !valid_block(threads))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: return launch_rows<1>(in, out, n, len, out_bytes, aligned, threads, st);
    case 25: return launch_rows<25>(in, out, n, len, out_bytes, aligned, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The Merkle levels above d0 (n digests of 25 bytes) into buf, all levels
// back to back, as nsteps launches of 6 words each (ops/keccak.py:
// _launches_of): kind (0 a level, 1 a subtree), the source's byte offset
// into buf (-1: d0 itself), the destination's byte offset, then for a
// level (parents, group, threads a block), for a subtree (width,
// num_layers, 0).
extern "C" int keccak_merkle_run(const uint8_t* d0, uint8_t* buf,
                                 const long long* steps, int nsteps,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  for (int k = 0; k < nsteps; ++k) {
    const long long* s = steps + 6 * k;
    const uint8_t* src = s[1] < 0 ? d0 : buf + s[1];
    uint8_t* dst = buf + s[2];
    const int err = s[0] == 0 ? level(src, dst, s[3], int(s[4]), int(s[5]), st)
                  : s[0] == 1 ? subtree(src, dst, s[3], int(s[4]), st)
                              : (int)cudaErrorInvalidValue;
    if (err) return err;
  }
  return 0;
}

// the hash-onion of n states of 12 canonical Goldilocks elements
extern "C" int keccak_permute(const uint64_t* in, uint64_t* out, long long n,
                              void* stream) {
  if (n > 0)
    permute_kernel<<<unsigned((n + THREADS - 1) / THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}
