// Dependent-chain probes: one field or integer operation applied `reps`
// times in a row, to read the card's real rate for it.
//
// Replaces the TPU probe kernels of scripts/:
//   profile_poseidon.py _mulchain_kernel, profile2.py _mulchain_kernel,
//   hwprobe3.py probe_gl                       -> probe_gl_mul
//   profile_poseidon.py _sboxchain_kernel, profile_sbox2.py _chain_kernel
//   with kp._sbox, hwprobe3.py probe_sbox       -> probe_gl_sbox
//   profile_sbox2.py _chain_kernel with kp._sqr -> probe_gl_sqr
//   profile_sbox2.py _chain_kernel with _sbox_serial -> probe_gl_sbox_serial
//   hwprobe3.py probe_u32 mul / mul16 / add / fma
//                     -> probe_u32_mul / probe_u32_mul16 / probe_u32_add /
//                        probe_f32_fma
//
// One thread per element, x0 and y in registers, one load and one store:
// the kernel is bound by the chain, never by memory.  `reps` is a runtime
// argument, so the marginal timing (t(2r) - t(r)) / r needs no rebuild.
// The GL steps run the port's own gl::mul and gl::sbox (gl.cuh), the ones
// the Poseidon kernels run, which keep every value canonical.  The main
// loop holds S::UNROLL steps and a back-edge (4-5 instructions), so its
// SASS body over S::UNROLL is the instruction count of one step, within
// one (probes.py `sass`).  A one-instruction step unrolls 64 times, so the
// loop takes 6% of the instruction slots and not a third, as at 8.
//
// The add and mul16 steps are written as inline PTX.  In C++ the compiler
// turns 64 adds of x0 into one y + 64 x0, and drops 51 of the 64 masks of
// the mul16 chain (only the low 16 bits reach the end); `asm volatile`
// keeps each step's instructions.  ptxas still emits two dependent adds
// as one three-input IADD3: u32_add counts adds.  The multiply and FMA
// chains compile to one IMAD or FFMA a step as they are.
#include <cstdint>
#include <cuda_runtime.h>

#include "gl.cuh"

namespace {

constexpr int THREADS = 256;

struct GlMul {
  using T = uint64_t;
  static constexpr int UNROLL = 8;
  static __device__ __forceinline__ T step(T y, T x0) { return gl::mul(y, x0); }
};

struct GlSqr {
  using T = uint64_t;
  static constexpr int UNROLL = 8;
  static __device__ __forceinline__ T step(T y, T) { return gl::mul(y, y); }
};

struct GlSbox {
  using T = uint64_t;
  static constexpr int UNROLL = 8;
  static __device__ __forceinline__ T step(T y, T) { return gl::sbox(y); }
};

// ((y * y^2)^2) * y: the same x^7 with two live values instead of four.
struct GlSboxSerial {
  using T = uint64_t;
  static constexpr int UNROLL = 8;
  static __device__ __forceinline__ T step(T y, T) {
    T t = gl::mul(y, y);
    t = gl::mul(t, y);
    t = gl::mul(t, t);
    return gl::mul(t, y);
  }
};

struct U32Mul {
  using T = uint32_t;
  static constexpr int UNROLL = 64;
  static __device__ __forceinline__ T step(T y, T x0) { return y * x0; }
};

struct U32Mul16 {
  using T = uint32_t;
  static constexpr int UNROLL = 64;
  static __device__ __forceinline__ T step(T y, T x0) {
    asm volatile("mul.lo.u32 %0, %0, %1;\n\tand.b32 %0, %0, 65535;"
                 : "+r"(y) : "r"(x0 >> 16));
    return y;
  }
};

struct U32Add {
  using T = uint32_t;
  static constexpr int UNROLL = 64;
  static __device__ __forceinline__ T step(T y, T x0) {
    asm volatile("add.u32 %0, %0, %1;" : "+r"(y) : "r"(x0));
    return y;
  }
};

struct F32Fma {
  using T = float;
  static constexpr int UNROLL = 64;
  static __device__ __forceinline__ T step(T y, T x0) {
    return fmaf(y, x0, 0.5f);
  }
};

template <class S>
__global__ void chain_kernel(const typename S::T* __restrict__ in,
                             typename S::T* __restrict__ out, int64_t n,
                             int reps) {
  using T = typename S::T;
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T x0 = in[i];
  T y = x0;
  int r = 0;
#pragma unroll 1
  for (; r + S::UNROLL <= reps; r += S::UNROLL) {
#pragma unroll
    for (int u = 0; u < S::UNROLL; ++u) y = S::step(y, x0);
  }
#pragma unroll 1
  for (; r < reps; ++r) y = S::step(y, x0);
  out[i] = y;
}

template <class S>
int launch(const void* in, void* out, long long n, int reps, void* stream) {
  using T = typename S::T;
  if (n > 0)
    chain_kernel<S><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                      (cudaStream_t)stream>>>((const T*)in, (T*)out, n, reps);
  return (int)cudaGetLastError();
}

}  // namespace

#define PROBE_ENTRY(name, S)                                           \
  extern "C" int probe_##name(const void* in, void* out, long long n, \
                              int reps, void* stream) {                \
    return launch<S>(in, out, n, reps, stream);                        \
  }                                                                    \
  extern "C" int probe_##name##_unroll() { return S::UNROLL; }

PROBE_ENTRY(gl_mul, GlMul)
PROBE_ENTRY(gl_sqr, GlSqr)
PROBE_ENTRY(gl_sbox, GlSbox)
PROBE_ENTRY(gl_sbox_serial, GlSboxSerial)
PROBE_ENTRY(u32_mul, U32Mul)
PROBE_ENTRY(u32_mul16, U32Mul16)
PROBE_ENTRY(u32_add, U32Add)
PROBE_ENTRY(f32_fma, F32Fma)
