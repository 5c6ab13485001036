// Goldilocks arithmetic, p = 2^64 - 2^32 + 1, on u64 registers.
//
// Every function takes and returns canonical values (< p), the invariant of
// field/gl.py, but add_lazy (and sub and mul, which also take an unreduced
// u64 where their comments say so).  The 64x64 -> 128 product uses
// __umul64hi; the reduction uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p),
// with an exact carry/borrow at each step, and returns a canonical value
// for any 128-bit product.
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;   // 2^64 mod p

__device__ __forceinline__ uint64_t canon(uint64_t x) {
  return x >= P ? x - P : x;
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // wrapped past 2^64; a, b < p keeps this < 2^64
  return canon(s);
}

// a + b for any a < 2^64 and b < p, unreduced (< 2^64, congruent): a carry
// out of 2^64 leaves a sum below b, so adding 2^64 mod p = EPS cannot carry
// again.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return s < a ? s + EPS : s;
}

// a - b for a < p (or, unreduced, any a < 2^64) and b < p: a borrow adds
// p, which leaves a - b + p in [0, p).
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  return a < b ? d - EPS : d;  // borrowed 2^64: add p = 2^64 - EPS
}

// (n2 * 2^64 + x) mod p for n2 < 2^32.
__device__ __forceinline__ uint64_t reduce96(uint64_t x, uint64_t n2) {
  uint64_t t1 = (n2 << 32) - n2;  // n2 * (2^32 - 1) < 2^64
  uint64_t t2 = x + t1;
  if (t2 < x) t2 += EPS;
  return canon(t2);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  uint64_t lo = a * b;
  uint64_t hi = __umul64hi(a, b);
  uint64_t n3 = hi >> 32;
  uint64_t t0 = lo - n3;
  if (lo < n3) t0 -= EPS;
  return reduce96(t0, hi & EPS);
}

// The Poseidon S-box x^7 = x^3 x^4: four multiplies, the squarings as
// mul(x, x).  Shared by the Poseidon kernels and the probe chains.
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = mul(x, x);
  const uint64_t x3 = mul(x2, x);
  const uint64_t x4 = mul(x2, x2);
  return mul(x3, x4);
}

}  // namespace gl
