// Batched Goldilocks NTT on u64 values: the cluster kernel of
// ntt_cluster.cuh for rows up to 2^15, and its bit-reversal launch and
// ntt.cuh's passes (tiles of 2^12 u64) above.
//
// Replaces the TPU kernel ops/ntt.py:_fft_fused (and _fft_four_step above
// 2^16) of plonky2_goldibear_tpu.  Bound on the H100: the butterflies, a
// gl::mul of about 30 instructions each (see ntt_cluster.cuh).  A 2^15
// row of u64 is 256 KB, more than one block's 227 KB of shared memory, so
// it takes a cluster of 8 or 16 blocks (a 4-word exchange buffer of 16
// bytes a word holds 2^12 u64 a block at 512 threads); at 8 a block needs
// 96 KB with the zero prefix of an LDE, so two share an SM.  A block keeps
// 64 registers under __launch_bounds__(512, 2).  The butterflies leave
// their sums unreduced (any u64 standing for its residue: the product
// reduces any u64 factor); the store brings each output to [0, p).
#include "gl.cuh"
#include "ntt.cuh"
#include "ntt_cluster.cuh"

namespace {

struct GL {
  using T = uint64_t;
  static constexpr int LOG_TILE = 12;         // the multi-pass schedule's tile
  static constexpr int CLUSTER_MAX_LOG = 15;  // rows up to 2^15 take one launch
  static constexpr int MAX_CLUSTER_LOG = 4;   // at most 16 blocks a cluster
  static constexpr int MAX_THREADS = 512;
  static constexpr int MIN_BLOCKS = 2;        // blocks an SM (__launch_bounds__)
  static constexpr int MAX_XCHG = 4;      // 16-byte words a thread sends
  static constexpr int MAX_R = 3;         // stages a pass takes (radix 2^MAX_R)
  static constexpr int MAX_SMEM = ntt_cluster::MAX_SMEM;
  // mul takes any u64 factors (the 128-bit product's reduction) and
  // returns a canonical value; add and sub take an unreduced x < 2^64 and a
  // canonical t and return an unreduced value (gl.cuh)
  static __device__ __forceinline__ T mul(T a, T b) { return gl::mul(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return gl::add_lazy(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return gl::sub(a, b); }
  static __device__ __forceinline__ T canon(T a) { return gl::canon(a); }
};

}  // namespace

extern "C" int ntt_gl_max_cluster_log() { return GL::MAX_CLUSTER_LOG; }
extern "C" int ntt_gl_cluster_max_log() { return GL::CLUSTER_MAX_LOG; }

extern "C" int ntt_gl_active_clusters(int c_log, int threads, int smem) {
  return ntt_cluster::active_clusters<GL>(c_log, threads, smem);
}

extern "C" int ntt_gl_cluster(const uint64_t* in, uint64_t* out,
                              const uint64_t* tw, long long batch, int n_log,
                              int c_log, int r, int threads, int clusters,
                              int smem, void* stream) {
  return ntt_cluster::launch_cluster<GL>(in, out, tw, batch, n_log, c_log, r,
                                         threads, clusters, smem, stream);
}

extern "C" int ntt_gl_bitrev(const uint64_t* in, uint64_t* out,
                             long long batch, int n_log, int r, void* stream) {
  return ntt_cluster::launch_bitrev(in, out, batch, n_log, r, stream);
}

extern "C" int ntt_gl_pass(const uint64_t* in, uint64_t* out,
                           const uint64_t* tw, long long batch, int n_log,
                           int s0, int s1, int s_begin, void* stream) {
  return ntt::launch_pass<GL, GL::LOG_TILE>(in, out, tw, batch, n_log, s0, s1,
                                            s_begin, stream);
}
