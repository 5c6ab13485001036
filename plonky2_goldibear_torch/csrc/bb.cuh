// BabyBear arithmetic, p = 2^31 - 2^27 + 1, on u32 registers holding
// Montgomery forms a * 2^32 mod p (field/bb.py's representation).
//
// Every function takes and returns canonical residues (< p).  The product
// is one 32x32 -> 64 multiply and a Montgomery reduction in its
// subtracting form: m = lo(t) * p^-1 mod 2^32, then hi(t) - hi(m p), plus p
// on a borrow (the low halves of t and m p are equal, so they cancel).  A
// result off by p in either direction is brought back by one unsigned min
// (fold), which also stands for the compare and select of a borrow.
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

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  const uint64_t t = uint64_t(a) * b;
  const uint32_t m = uint32_t(t) * PINV;
  const uint32_t r = uint32_t(t >> 32) - __umulhi(m, P);   // in (-p, p)
  return fold(r, r + P);
}

}  // namespace bb
