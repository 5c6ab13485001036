// Batched BabyBear NTT on u32 Montgomery forms: radix-2 DIT, natural order
// in and out, with the LDE zero-prefix skip.
//
// Replaces the TPU kernel ops/ntt_bb.py:_fft_fused (with fft and, above
// 2^16, _fft_four_step) of plonky2_goldibear_tpu.  The butterfly is one
// Montgomery product and a canonical add and subtract (bb.cuh); twiddles
// are Montgomery forms, so the transform stays in the Montgomery domain.
//
// Bound on the H100: a row of 2^15 u32 is 128 KB, so the prover's rows
// (2^6 to 2^15) need one read of the nonzero coefficients and one write of
// the row; the butterflies are a few hundred integer instructions per
// element.  What held the earlier kernel back was neither: a single row
// ran on one to four blocks, its first pass gathered the bit-reversed
// input from scattered addresses, and every butterfly read its twiddle
// from global memory.  Design (ntt_bb_cluster), a four-step split of the
// row over a thread-block cluster of C = 2^c blocks, L = n / C positions a
// block, index g = (hi, lo) with hi < C, lo < L:
//   * One launch, one pass over device memory for every row up to 2^15;
//     ops/ntt_bb.py:plan chooses C per launch so that a batch of one to
//     six rows still spreads over the card and a wide batch keeps the SMs
//     full.  A cluster walks rows id, id + clusters, ... (persistent), so
//     its twiddles are loaded into shared memory once.
//   * Load: block hi holds positions (hi, lo); the coefficient at (hi, lo)
//     of the bit-reversed row is x[(rev(lo >> r) << c) | rev(hi)], so the
//     block reads every C-th of the n >> r nonzero coefficients (the C
//     blocks of the cluster together read each sector once) and stores
//     each once, at its bit-reversed place in a compact buffer whose
//     top-bits swizzle keeps a warp's 32 stores in 32 banks.  Stage r, the
//     first the zero prefix leaves, reads the compact buffer (the 2^r
//     copies of a coefficient are implicit).
//   * The stages on lo run in the block's shared memory (__syncthreads).
//     Then one exchange through distributed shared memory (16-byte remote
//     stores, one cluster barrier before and one after) hands block b the
//     positions (hi, lo) with lo in [b L / C, (b + 1) L / C) for every hi,
//     and the c stages on hi run locally too.
//   * Twiddles sit in shared memory: the rows of the stages on lo (the
//     first L - 1 words of the global table) and, for the stages on hi, the
//     twiddles of this block's lo range.  Stages go MAX_R at a time (one
//     trip through shared memory for several stages), loads first.
//   * Store: runs of L / C consecutive words (L for one block), 16 bytes a
//     thread.
// Rows above 2^15 (up to 2^26) keep the multi-pass schedule of ntt.cuh,
// after one coalesced bit-reversal pass (ntt_bb_bitrev: 32 x 32 tiles
// transposed in shared memory) in place of its scattered first load.
#include <cooperative_groups.h>

#include "bb.cuh"
#include "ntt.cuh"

namespace cg = cooperative_groups;

extern __shared__ uint4 ntt_smem[];   // a block's dynamic shared memory

namespace {

struct BB {
  using T = uint32_t;
  static __device__ __forceinline__ T mul(T a, T b) { return bb::mul(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return bb::add(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return bb::sub(a, b); }
};

constexpr int LOG_TILE = 13;         // the multi-pass schedule's tile
constexpr int CLUSTER_MAX_LOG = 15;  // rows up to 2^15 take one launch
constexpr int MAX_CLUSTER_LOG = 4;   // at most 16 blocks a cluster
constexpr int MAX_THREADS = 512;
constexpr int MAX_SMEM = 232448;     // bytes of shared memory a block can use

__device__ __forceinline__ uint32_t rev_bits(uint32_t x, int bits) {
  return bits == 0 ? 0 : __brev(x) >> (32 - bits);
}

// Shared words of one block: its L positions, the compact buffer of the
// L >> r nonzero coefficients, the L - 1 twiddles of the stages on lo (and
// one spare word), and the L - L / C twiddles of the stages on hi
// (ops/ntt_bb.py:smem_bytes computes the same size).
__host__ __device__ constexpr long long smem_words(int n_log, int c_log,
                                                   int r) {
  return (3LL << (n_log - c_log)) + ((1LL << (n_log - c_log)) >> r) -
         (1LL << (n_log - 2 * c_log));
}

// The compact buffer's address of position p < 2^m: the top bits of p
// XORed into its low five, so the bit-reversed stores of a warp (which
// differ in their top bits) fall in distinct banks.
__device__ __forceinline__ int swz(int p, int m) {
  return p ^ (p >> (m - 5 > 5 ? m - 5 : 5));
}

constexpr int MAX_XCHG = 4;      // 16-byte words a thread sends (L <= 2^13)
constexpr int MAX_R = 3;         // stages a pass takes (radix 2^MAX_R)

// Stages s .. s + R - 1 at once, one trip through shared memory (radix
// 2^R): unit v < nunits takes positions e + i h, i < 2^R, h = 2^s, e =
// (v >> s) << (s + R) | k, k = v mod h; stage s + j pairs i and i + 2^j
// with the twiddle at k + (i mod 2^j) h of its row, tw + ((2^(a + j) - 1)
// mult).  FROM_COMPACT: the inputs are compact positions (e >> s) + i of
// a first stage s = r (the zero prefix's copies are implicit).
template <int R, bool FROM_COMPACT>
__device__ __forceinline__ void radix_pass(uint32_t* data, const uint32_t* compact,
                                           int m_log, int s, const uint32_t* tw,
                                           int a, int mult, int nunits) {
  constexpr int M = 1 << R;
  const int h = 1 << s;
  for (int v = threadIdx.x; v < nunits; v += blockDim.x) {
    const int q = v >> s, k = v & (h - 1);
    const int e = (q << (s + R)) + k;
    uint32_t x[M];
#pragma unroll
    for (int i = 0; i < M; ++i)
      x[i] = FROM_COMPACT ? compact[swz(M * q + i, m_log)] : data[e + i * h];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t* row = tw + ((1 << (a + j)) - 1) * mult + k;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i & (1 << j)) continue;
        const uint32_t t = bb::mul(x[i + (1 << j)], row[(i & ((1 << j) - 1)) * h]);
        x[i + (1 << j)] = bb::sub(x[i], t);
        x[i] = bb::add(x[i], t);
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) data[e + i * h] = x[i];
  }
}

// One pass of R <= 3 stages from s (runtime radix).
__device__ __forceinline__ void run_pass(int R, bool from_compact, uint32_t* data,
                                         const uint32_t* compact, int m_log,
                                         int s, const uint32_t* tw, int a,
                                         int mult, int positions) {
  const int nunits = positions >> R;
  if (from_compact) {
    if (R == 3) radix_pass<3, true>(data, compact, m_log, s, tw, a, mult, nunits);
    else if (R == 2) radix_pass<2, true>(data, compact, m_log, s, tw, a, mult, nunits);
    else radix_pass<1, true>(data, compact, m_log, s, tw, a, mult, nunits);
  } else {
    if (R == 3) radix_pass<3, false>(data, compact, m_log, s, tw, a, mult, nunits);
    else if (R == 2) radix_pass<2, false>(data, compact, m_log, s, tw, a, mult, nunits);
    else radix_pass<1, false>(data, compact, m_log, s, tw, a, mult, nunits);
  }
}

// Rows (batch, 2^n_log) of `in` (only the first 2^(n_log - r) entries of
// a row read) -> their NTTs in `out`.  tw[(1 << s) - 1 + k] = w_{2^(s+1)}^k.
// Needs n_log - c_log > r when c_log > 0, L / C >= 4, and at most
// MAX_XCHG words of exchange a thread.
__device__ void ntt_cluster_body(uint32_t* smem, const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out,
                                 const uint32_t* __restrict__ tw,
                                 long long batch, int n_log, int c_log, int r) {
  cg::cluster_group cluster = cg::this_cluster();
  const int l_log = n_log - c_log;      // positions of a block
  const int lc_log = l_log - c_log;     // of a block's lo range
  const int L = 1 << l_log, Lc = 1 << lc_log;
  const int m_log = l_log - r;          // compact positions of a block
  const int rank = c_log ? int(cluster.block_rank()) : 0;
  uint32_t* data = smem;
  uint32_t* compact = data + L;
  uint32_t* twl = compact + (L >> r);
  uint32_t* twh = twl + L;
  for (int i = threadIdx.x; i < L - 1; i += blockDim.x) twl[i] = tw[i];
  for (int t = 0; t < c_log; ++t) {   // hi stage t: k = (hi mod 2^t) L + lo
    const uint32_t* row = tw + ((1LL << (l_log + t)) - 1) + rank * Lc;
    uint32_t* dst = twh + ((1 << t) - 1) * Lc;
    for (int i = threadIdx.x; i < (Lc << t); i += blockDim.x)
      dst[i] = row[((long long)(i >> lc_log) << l_log) + (i & (Lc - 1))];
  }
  const long long n = 1LL << n_log;
  const uint32_t rrank = rev_bits(uint32_t(rank), c_log);
  const long long first = blockIdx.x >> c_log;
  const long long clusters = gridDim.x >> c_log;
  for (long long row = first; row < batch; row += clusters) {
    // this block's coefficients of the row, x[(j << c) | rev(rank)] for
    // j < 2^m_log, each stored at its bit-reversed place
    const uint32_t* src = in + row * n;
    __syncthreads();   // the last row's store has read `data`
    for (int j = threadIdx.x; j < (1 << m_log); j += blockDim.x)
      compact[swz(int(rev_bits(uint32_t(j), m_log)), m_log)] =
          src[((long long)j << c_log) | rrank];
    __syncthreads();
    if (r == l_log) {   // r == n_log: every output is the one coefficient
      for (int e = threadIdx.x; e < L; e += blockDim.x) data[e] = compact[0];
      __syncthreads();
    }
    // stages r .. l_log - 1 on lo, up to MAX_R a pass, the first from the
    // compact buffer
    for (int s = r; s < l_log;) {
      const int R = l_log - s < MAX_R ? l_log - s : MAX_R;
      run_pass(R, s == r, data, compact, m_log, s, twl, s, 1, L);
      s += R;
      __syncthreads();
    }
    if (c_log) {
      // block b sends (b, lo) to block lo >> lc_log, at b Lc + lo mod Lc
      uint4 v[MAX_XCHG];
      uint4* data4 = reinterpret_cast<uint4*>(data);
#pragma unroll
      for (int u = 0; u < MAX_XCHG; ++u) {
        const int i = threadIdx.x + u * blockDim.x;
        if (i < L / 4) v[u] = data4[i];
      }
      cluster.sync();
#pragma unroll
      for (int u = 0; u < MAX_XCHG; ++u) {
        const int i = threadIdx.x + u * blockDim.x;
        if (i < L / 4) {
          const int lo = 4 * i;
          uint4* dst = reinterpret_cast<uint4*>(
              cluster.map_shared_rank(data, lo >> lc_log));
          dst[(rank * Lc + (lo & (Lc - 1))) / 4] = v[u];
        }
      }
      cluster.sync();
      // stages on hi, local now: stage t is local stage lc_log + t
      for (int t = 0; t < c_log;) {
        const int R = c_log - t < MAX_R ? c_log - t : MAX_R;
        run_pass(R, false, data, compact, m_log, lc_log + t, twh, t, Lc, L);
        t += R;
        __syncthreads();
      }
    }
    // local index e = hi Lc + lo' is position hi L + rank Lc + lo'
    if (L < 4) {        // a row of one or two (one block)
      for (int e = threadIdx.x; e < L; e += blockDim.x) out[row * n + e] = data[e];
      continue;
    }
    const uint4* data4 = reinterpret_cast<const uint4*>(data);
    uint4* dst4 = reinterpret_cast<uint4*>(out + row * n);
    for (int i = threadIdx.x; i < L / 4; i += blockDim.x) {
      const int e = 4 * i;
      dst4[(((long long)(e >> lc_log) << l_log) + rank * Lc + (e & (Lc - 1))) / 4] =
          data4[i];
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
ntt_cluster_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ tw, long long batch, int n_log,
                   int c_log, int r) {
  ntt_cluster_body(reinterpret_cast<uint32_t*>(ntt_smem), in, out, tw, batch,
                   n_log, c_log, r);
}

// y[(rev_m(i) << r) + t] = x[i] for i < 2^m, t < 2^r, m = n_log - r >= 10:
// with i = (a, mid, c), a and c of 5 bits, rev_m(i) = (rev c, rev mid,
// rev a); a block takes one (row, mid) and its 32 x 32 (a, c) tile, read
// along c and written along rev a.
__global__ void __launch_bounds__(256)
bitrev_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
              int n_log, int r) {
  __shared__ uint32_t tile[32][33];
  const int m_log = n_log - r;
  const int mid_log = m_log - 10;
  const long long row = blockIdx.x >> mid_log;
  const uint32_t mid = blockIdx.x & ((1u << mid_log) - 1);
  const uint32_t* src = in + (row << n_log);
  uint32_t* dst = out + (row << n_log);
  const int tx = threadIdx.x & 31;
  for (int ty = threadIdx.x >> 5; ty < 32; ty += blockDim.x >> 5)
    tile[ty][tx] = src[((long long)ty << (m_log - 5)) | (mid << 5) | tx];
  __syncthreads();
  const uint32_t rmid = rev_bits(mid, mid_log);
  for (int ty = threadIdx.x >> 5; ty < 32; ty += blockDim.x >> 5) {
    const uint32_t v = tile[rev_bits(tx, 5)][rev_bits(ty, 5)];
    const long long o = ((long long)ty << (m_log - 5)) | (rmid << 5) | tx;
    for (int t = 0; t < (1 << r); ++t) dst[(o << r) + t] = v;
  }
}

}  // namespace

extern "C" int ntt_bb_max_cluster_log() { return MAX_CLUSTER_LOG; }
extern "C" int ntt_bb_cluster_max_log() { return CLUSTER_MAX_LOG; }

namespace {

cudaLaunchConfig_t cluster_config(int c_log, int threads, int clusters,
                                  int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(clusters) << c_log, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << c_log;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

void configure() {
  static bool done = false;
  if (!done) {
    cudaFuncSetAttribute(ntt_cluster_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    cudaFuncSetAttribute(ntt_cluster_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    done = true;
  }
}

}  // namespace

// Clusters of this shape the card holds at once (the occupancy query,
// remembered per shape): a persistent launch takes no more, or the rest
// would wait for whole clusters to finish all their rows.
extern "C" int ntt_bb_active_clusters(int c_log, int threads, int smem) {
  static long long keys[256];
  static int counts[256];
  const long long key = ((long long)smem << 16) | (threads << 4) | c_log;
  int i = 0;
  for (; i < 256 && keys[i] != 0; ++i)
    if (keys[i] == key) return counts[i];
  configure();
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(c_log, threads, 1, smem, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, ntt_cluster_kernel, &cfg) != cudaSuccess ||
      n < 1)
    n = 1;
  if (i < 256) {
    keys[i] = key;
    counts[i] = n;
  }
  return n;
}

// One launch of at most `clusters` clusters of 2^c_log blocks of `threads`
// threads, `smem` bytes of shared memory each (ops/ntt_bb.py:plan); no
// more clusters than the card holds at once.
extern "C" int ntt_bb_cluster(const uint32_t* in, uint32_t* out,
                              const uint32_t* tw, long long batch, int n_log,
                              int c_log, int r, int threads, int clusters,
                              int smem, void* stream) {
  if (n_log < 0 || n_log > CLUSTER_MAX_LOG || c_log < 0 ||
      c_log > MAX_CLUSTER_LOG || c_log > n_log - r || r < 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || clusters < 1 ||
      (c_log && (n_log - c_log <= r || n_log - 2 * c_log < 2 ||
                 (1 << (n_log - c_log)) > 4 * MAX_XCHG * threads)) ||
      smem != 4 * smem_words(n_log, c_log, r) || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  configure();
  const int active = ntt_bb_active_clusters(c_log, threads, smem);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(c_log, threads, clusters < active ? clusters : active, smem,
                     (cudaStream_t)stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ntt_cluster_kernel, in, out,
                                             tw, batch, n_log, c_log, r);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int ntt_bb_bitrev(const uint32_t* in, uint32_t* out,
                             long long batch, int n_log, int r, void* stream) {
  if (n_log - r < 10 || r < 0) return (int)cudaErrorInvalidValue;
  bitrev_kernel<<<unsigned(batch << (n_log - r - 10)), 256, 0,
                  (cudaStream_t)stream>>>(in, out, n_log, r);
  return (int)cudaGetLastError();
}

extern "C" int ntt_bb_pass(const uint32_t* in, uint32_t* out,
                           const uint32_t* tw, long long batch, int n_log,
                           int s0, int s1, int s_begin, int load_bitrev,
                           int zero_log, void* stream) {
  return ntt::launch_pass<BB, LOG_TILE>(in, out, tw, batch, n_log, s0, s1,
                                        s_begin, load_bitrev, zero_log, stream);
}
