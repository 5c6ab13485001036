// Batched BabyBear NTT on u32 Montgomery forms: the cluster kernel of
// ntt_cluster.cuh for rows up to 2^15, and its bit-reversal launch and
// ntt.cuh's passes above.
//
// Replaces the TPU kernel ops/ntt_bb.py:_fft_fused (with fft and, above
// 2^16, _fft_four_step) of plonky2_goldibear_tpu.  The butterfly is one
// Montgomery product and a canonical add and subtract (bb.cuh); twiddles
// are Montgomery forms, so the transform stays in the Montgomery domain.
// Bound on the H100: the butterflies, about 13 instructions each (see
// ntt_cluster.cuh).  A 2^15 row of 128 KB and its twiddles do not fit one
// block, so such rows take clusters of 4 or more; under
// __launch_bounds__(512, 2) and a 4-word exchange buffer a block keeps 64
// registers, so two 512-thread blocks share an SM; radix-8 passes.
#include "bb.cuh"
#include "ntt.cuh"
#include "ntt_cluster.cuh"

namespace {

struct BB {
  using T = uint32_t;
  static constexpr int LOG_TILE = 13;         // the multi-pass schedule's tile
  static constexpr int CLUSTER_MAX_LOG = 15;  // rows up to 2^15 take one launch
  static constexpr int MAX_CLUSTER_LOG = 4;   // at most 16 blocks a cluster
  static constexpr int MAX_THREADS = 512;
  static constexpr int MIN_BLOCKS = 2;        // blocks an SM (__launch_bounds__)
  static constexpr int MAX_XCHG = 4;      // 16-byte words a thread sends
  static constexpr int MAX_R = 3;         // stages a pass takes (radix 2^MAX_R)
  static constexpr int MAX_SMEM = ntt_cluster::MAX_SMEM;
  static __device__ __forceinline__ T mul(T a, T b) { return bb::mul(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return bb::add(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return bb::sub(a, b); }
  static __device__ __forceinline__ T canon(T a) { return a; }   // always
};

}  // namespace

extern "C" int ntt_bb_max_cluster_log() { return BB::MAX_CLUSTER_LOG; }
extern "C" int ntt_bb_cluster_max_log() { return BB::CLUSTER_MAX_LOG; }

extern "C" int ntt_bb_active_clusters(int c_log, int threads, int smem) {
  return ntt_cluster::active_clusters<BB>(c_log, threads, smem);
}

extern "C" int ntt_bb_cluster(const uint32_t* in, uint32_t* out,
                              const uint32_t* tw, long long batch, int n_log,
                              int c_log, int r, int threads, int clusters,
                              int smem, void* stream) {
  return ntt_cluster::launch_cluster<BB>(in, out, tw, batch, n_log, c_log, r,
                                         threads, clusters, smem, stream);
}

extern "C" int ntt_bb_bitrev(const uint32_t* in, uint32_t* out,
                             long long batch, int n_log, int r, void* stream) {
  return ntt_cluster::launch_bitrev(in, out, batch, n_log, r, stream);
}

extern "C" int ntt_bb_pass(const uint32_t* in, uint32_t* out,
                           const uint32_t* tw, long long batch, int n_log,
                           int s0, int s1, int s_begin, void* stream) {
  return ntt::launch_pass<BB, BB::LOG_TILE>(in, out, tw, batch, n_log, s0, s1,
                                            s_begin, stream);
}
