// BabyBear arithmetic, p = 2^31 - 2^27 + 1, on u32 registers holding
// Montgomery forms a * 2^32 mod p (field/bb.py's representation).
//
// add, sub and mul take and return canonical residues (< p).  The product
// is one 32x32 -> 64 multiply and a Montgomery reduction in its
// subtracting form (redc): m = lo(t) * p^-1 mod 2^32, then hi(t) - hi(m p),
// plus p on a borrow (the low halves of t and m p are equal, so they
// cancel).  A result off by p in either direction is brought back by one
// unsigned min (fold), which also stands for the compare and select of a
// borrow.
//
// The reduction needs only t < p 2^32 (then hi(t) < p and the difference
// lies in (-p, p)), so a factor may be unreduced: a < 2^32 times b < p,
// or a < 2p times b < 2^31; and a sum of two products of canonical values,
// < 2 p^2 < p 2^32, takes one reduction (redc of a fused multiply-add).
// mul_lazy leaves its result in (0, 2p), one instruction short of
// canonical.  Where a caller relies on such a bound it says so.
#pragma once
#include <cstdint>

namespace bb {

constexpr uint32_t P = 0x78000001u;
constexpr uint32_t PINV = 0x88000001u;   // p^-1 mod 2^32

// x mod p for x in [0, p) or x in [2^32 - p, 2^32) standing for x - 2^32,
// given y = x + p mod 2^32: the smaller of the two as unsigned values (one
// min instruction, no compare and select).
__device__ __forceinline__ uint32_t fold(uint32_t x, uint32_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2p < 2^32
  return fold(s - P, s);     // s - P wraps exactly when s < P
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;  // wraps exactly when a < b
  return fold(d, d + P);
}

// t / 2^32 mod p for t < p 2^32, in (-p, p) (negative values wrapped).
__device__ __forceinline__ uint32_t redc_signed(uint64_t t) {
  const uint32_t m = uint32_t(t) * PINV;
  return uint32_t(t >> 32) - __umulhi(m, P);
}

// t / 2^32 mod p for t < p 2^32, canonical.
__device__ __forceinline__ uint32_t redc(uint64_t t) {
  const uint32_t r = redc_signed(t);
  return fold(r, r + P);
}

// The Montgomery product a b / 2^32 mod p, canonical; a b < p 2^32.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  return redc(uint64_t(a) * b);
}

// The same product in (0, 2p); a b < p 2^32.
__device__ __forceinline__ uint32_t mul_lazy(uint32_t a, uint32_t b) {
  return redc_signed(uint64_t(a) * b) + P;
}

}  // namespace bb
