// Batched Goldilocks NTT (the schedule of ntt.cuh on u64 values).
//
// Replaces the TPU kernel ops/ntt.py:_fft_fused (and _fft_four_step above
// 2^16) of plonky2_goldibear_tpu.  A tile of 2^12 u64 (32 KB): one pass for
// the prover's 2^12 iFFTs, two for its 2^15 LDEs, three at 2^25.
#include "gl.cuh"
#include "ntt.cuh"

namespace {

struct GL {
  using T = uint64_t;
  static __device__ __forceinline__ T mul(T a, T b) { return gl::mul(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return gl::add(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return gl::sub(a, b); }
};

}  // namespace

extern "C" int ntt_gl_pass(const uint64_t* in, uint64_t* out,
                           const uint64_t* tw, long long batch, int n_log,
                           int s0, int s1, int s_begin, int load_bitrev,
                           int zero_log, void* stream) {
  return ntt::launch_pass<GL, 12>(in, out, tw, batch, n_log, s0, s1, s_begin,
                                  load_bitrev, zero_log, stream);
}
