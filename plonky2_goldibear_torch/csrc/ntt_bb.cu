// Batched BabyBear NTT (the schedule of ntt.cuh on u32 Montgomery forms).
//
// Replaces the TPU kernel ops/ntt_bb.py:_fft_fused (and _fft_four_step above
// 2^16) of plonky2_goldibear_tpu.  The butterfly is one Montgomery product
// and a canonical add and subtract (bb.cuh); the twiddles are Montgomery
// forms, so the transform stays in the Montgomery domain.  A u32 tile holds
// 2^13 elements in the 32 KB a u64 tile of 2^12 takes: one pass for the
// prover's 2^12 iFFTs, two for its 2^15 LDEs and for 2^25 (the TPU's
// four-step above 2^16 is not needed).
#include "bb.cuh"
#include "ntt.cuh"

namespace {

struct BB {
  using T = uint32_t;
  static __device__ __forceinline__ T mul(T a, T b) { return bb::mul(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return bb::add(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return bb::sub(a, b); }
};

}  // namespace

extern "C" int ntt_bb_pass(const uint32_t* in, uint32_t* out,
                           const uint32_t* tw, long long batch, int n_log,
                           int s0, int s1, int s_begin, int load_bitrev,
                           int zero_log, void* stream) {
  return ntt::launch_pass<BB, 13>(in, out, tw, batch, n_log, s0, s1, s_begin,
                                  load_bitrev, zero_log, stream);
}
