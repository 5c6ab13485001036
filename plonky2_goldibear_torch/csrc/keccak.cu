// Keccak-f[1600] and the three hashing entry points of the Keccak
// configuration (the reference's KeccakHash<25>, plonky2/src/hash/
// keccak.rs:14-126): Keccak-256 with the original 0x01 ... 0x80 padding
// and a rate of 136 bytes, its first 25 bytes kept as a digest.
//
//   keccak_rows          the digest of each of n rows of L bytes: the leaf
//                        hashes (Goldilocks rows viewed as their bytes)
//   keccak_merkle_levels one launch of the row kernel a level down to the
//                        cap: a dense level of m digests is m / 2 rows of
//                        50 bytes, because siblings are adjacent
//   keccak_permute       the hash-onion over 12 Goldilocks elements with
//                        rejection sampling into the field (keccak.rs:63-98)
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
// most 136 bytes read and 25 written a block; so every launch here is
// bound by its instructions, not by memory.  Design, the simple one: one
// thread a message, its 25 lanes in registers and the round's steps
// unrolled (the rounds in a loop, their constants in constant memory), a
// 64-bit rotate as two 32-bit funnel shifts, chi left to the compiler's
// three-input logic ops.  Rows are read a 64-bit lane at a time where the
// row length is a multiple of 8 bytes, else byte by byte.  Not done yet:
// coalesced row loads through shared memory (a warp reads 32 rows 1080
// bytes apart) and fused narrow levels.
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
constexpr int THREADS = 128;
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

// rotate left by a constant: two funnel shifts on the halves
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

// Keccak-256 of the len bytes at p, into the state a.  ALIGNED: p and len
// are multiples of 8 bytes.
template <bool ALIGNED>
__device__ __forceinline__ void absorb(const uint8_t* p, int len,
                                       uint64_t a[25]) {
#pragma unroll
  for (int j = 0; j < 25; ++j) a[j] = 0;
  int off = 0;
  for (; len - off >= RATE_BYTES; off += RATE_BYTES) {
#pragma unroll
    for (int j = 0; j < RATE_LANES; ++j)
      a[j] ^= load_lane<ALIGNED>(p + off + 8 * j);
    keccak_f(a);
  }
  // the last block: the rem bytes left, 0x01 after them, 0x80 at its end
  const int rem = len - off;
#pragma unroll
  for (int j = 0; j < RATE_LANES; ++j) {
    const int b0 = 8 * j;
    uint64_t v = 0;
    if (b0 + 8 <= rem)
      v = load_lane<ALIGNED>(p + off + b0);
    else if (b0 < rem)
      v = load_partial(p + off + b0, rem - b0);
    if (b0 <= rem && rem < b0 + 8) v ^= 1ull << (8 * (rem - b0));
    a[j] ^= v;
  }
  a[RATE_LANES - 1] ^= PAD_LAST;
  keccak_f(a);
}

// the first out_bytes (<= 32) bytes of the hash in a
__device__ __forceinline__ void store_digest(const uint64_t a[25],
                                             uint8_t* out, int out_bytes) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (i < out_bytes) out[i] = (uint8_t)(a[i / 8] >> (8 * (i % 8)));
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            long long n, int len, int out_bytes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t a[25];
  absorb<ALIGNED>(in + i * len, len, a);
  store_digest(a, out + i * out_bytes, out_bytes);
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
               long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  onion(in + i * ONION_WIDTH, out + i * ONION_WIDTH);
}

unsigned blocks_for(long long n) {
  return unsigned((n + THREADS - 1) / THREADS);
}

}  // namespace

// n rows of len bytes -> n digests of out_bytes (1 to 32) bytes.
// aligned: in and len are multiples of 8 bytes.
extern "C" int keccak_rows(const uint8_t* in, uint8_t* out, long long n,
                           int len, int out_bytes, int aligned,
                           void* stream) {
  if (len < 0 || out_bytes < 1 || out_bytes > 32)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (aligned)
    rows_kernel<true><<<blocks_for(n), THREADS, 0, st>>>(in, out, n, len,
                                                          out_bytes);
  else
    rows_kernel<false><<<blocks_for(n), THREADS, 0, st>>>(in, out, n, len,
                                                           out_bytes);
  return (int)cudaGetLastError();
}

// n digests of 25 bytes -> the num_layers levels above them, written one
// after the other to out (n / 2, n / 4, ... digests); one launch a level.
extern "C" int keccak_merkle_levels(const uint8_t* in, uint8_t* out,
                                    long long n, int num_layers,
                                    void* stream) {
  if (num_layers < 0 || (num_layers > 0 && (n >> num_layers) < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* cur = in;
  for (int k = 0; k < num_layers; ++k) {
    const long long parents = n >> (k + 1);
    rows_kernel<false><<<blocks_for(parents), THREADS, 0, st>>>(
        cur, out, parents, 2 * DIGEST, DIGEST);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    cur = out;
    out += parents * DIGEST;
  }
  return 0;
}

// the hash-onion of n states of 12 canonical Goldilocks elements
extern "C" int keccak_permute(const uint64_t* in, uint64_t* out, long long n,
                              void* stream) {
  if (n > 0)
    permute_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        in, out, n);
  return (int)cudaGetLastError();
}
