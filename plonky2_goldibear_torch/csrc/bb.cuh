// BabyBear arithmetic, p = 2^31 - 2^27 + 1, on u32 registers holding
// Montgomery forms a * 2^32 mod p (field/bb.py's representation).
//
// Every function takes and returns canonical residues (< p).  The product
// is one 32x32 -> 64 multiply and a Montgomery reduction in its
// subtracting form: m = lo(t) * p^-1 mod 2^32, then hi(t) - hi(m p), plus p
// on a borrow (the low halves of t and m p are equal, so they cancel).
#pragma once
#include <cstdint>

namespace bb {

constexpr uint32_t P = 0x78000001u;
constexpr uint32_t PINV = 0x88000001u;   // p^-1 mod 2^32

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2p < 2^32
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;
  return a < b ? d + P : d;
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  const uint64_t t = uint64_t(a) * b;
  const uint32_t m = uint32_t(t) * PINV;
  const uint32_t t_hi = uint32_t(t >> 32);
  const uint32_t mp_hi = __umulhi(m, P);
  const uint32_t r = t_hi - mp_hi;
  return t_hi < mp_hi ? r + P : r;
}

}  // namespace bb
