// Batched radix-2 DIT NTT, natural order in and out, with the LDE
// zero-prefix skip, templated on the field: one row in the shared memory
// of a thread-block cluster (rows up to 2^CLUSTER_MAX_LOG), and the
// coalesced bit-reversal launch that precedes ntt.cuh's passes for longer
// rows.  ntt_bb.cu (BabyBear Montgomery forms, u32) and ntt_gl.cu
// (Goldilocks, u64) instantiate it.
//
// Bound on the H100: the butterflies.  A row of 2^15 is 128 KB (u32) or
// 256 KB (u64); one read of the nonzero coefficients and one write of the
// row are a few microseconds of device memory for a prove's batches,
// while every butterfly is a field multiply (13 instructions BabyBear, 30
// Goldilocks) and an add and a subtract.  Design (cluster_kernel), a
// four-step split of the row over a cluster of C = 2^c blocks, L = n / C
// positions a block, index g = (hi, lo) with hi < C, lo < L:
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
//     top-bits swizzle keeps a warp's stores apart in the banks.  Stage r,
//     the first the zero prefix leaves, reads the compact buffer (the 2^r
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
// after one coalesced bit-reversal pass (bitrev_kernel: 32 x 32 tiles
// transposed in shared memory).
//
// Field must provide: typename T (uint32_t or uint64_t); static __device__
// T mul(T, T), add, sub and canon.  A value between stages may stand for
// its residue unreduced where the field allows it (Goldilocks: any u64; add
// and sub take such an x and a canonical product t); canon brings an
// output to [0, p) at the store.  Also the launch
// limits MAX_THREADS, MIN_BLOCKS (__launch_bounds__), MAX_CLUSTER_LOG,
// CLUSTER_MAX_LOG, MAX_XCHG (16-byte words a thread sends in the
// exchange) and MAX_R (stages a pass takes).
#pragma once
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

extern __shared__ uint4 ntt_smem[];   // a block's dynamic shared memory

namespace ntt_cluster {

namespace cg = cooperative_groups;

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
// XORed into its low SB, so the bit-reversed stores of a warp (which
// differ in their top bits) fall in distinct banks.  A warp's 4-byte
// accesses take 32 banks at once (SB = 5); 8-byte ones go by half-warps
// of 16 words, which the low 4 bits place (SB = 4).
template <typename T>
__device__ __forceinline__ int swz(int p, int m) {
  constexpr int SB = sizeof(T) == 4 ? 5 : 4;
  return p ^ (p >> (m - SB > SB ? m - SB : SB));
}

// Stages s .. s + R - 1 at once, one trip through shared memory (radix
// 2^R): unit v < nunits takes positions e + i h, i < 2^R, h = 2^s, e =
// (v >> s) << (s + R) | k, k = v mod h; stage s + j pairs i and i + 2^j
// with the twiddle at k + (i mod 2^j) h of its row, tw + ((2^(a + j) - 1)
// mult).  FROM_COMPACT: the inputs are compact positions (e >> s) + i of
// a first stage s = r (the zero prefix's copies are implicit).
template <typename Field, int R, bool FROM_COMPACT>
__device__ __forceinline__ void radix_pass(typename Field::T* data,
                                           const typename Field::T* compact,
                                           int m_log, int s,
                                           const typename Field::T* tw, int a,
                                           int mult, int nunits) {
  using T = typename Field::T;
  constexpr int M = 1 << R;
  const int h = 1 << s;
  for (int v = threadIdx.x; v < nunits; v += blockDim.x) {
    const int q = v >> s, k = v & (h - 1);
    const int e = (q << (s + R)) + k;
    T x[M];
#pragma unroll
    for (int i = 0; i < M; ++i)
      x[i] = FROM_COMPACT ? compact[swz<T>(M * q + i, m_log)] : data[e + i * h];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const T* row = tw + ((1 << (a + j)) - 1) * mult + k;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i & (1 << j)) continue;
        const T t = Field::mul(x[i + (1 << j)], row[(i & ((1 << j) - 1)) * h]);
        x[i + (1 << j)] = Field::sub(x[i], t);
        x[i] = Field::add(x[i], t);
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) data[e + i * h] = x[i];
  }
}

// One pass of R <= Field::MAX_R stages from s (runtime radix).
template <typename Field, bool FROM_COMPACT>
__device__ __forceinline__ void run_pass_from(int R, typename Field::T* data,
                                              const typename Field::T* compact,
                                              int m_log, int s,
                                              const typename Field::T* tw,
                                              int a, int mult, int nunits) {
  if (Field::MAX_R >= 3 && R == 3)
    radix_pass<Field, (Field::MAX_R >= 3 ? 3 : 1), FROM_COMPACT>(
        data, compact, m_log, s, tw, a, mult, nunits);
  else if (Field::MAX_R >= 2 && R == 2)
    radix_pass<Field, (Field::MAX_R >= 2 ? 2 : 1), FROM_COMPACT>(
        data, compact, m_log, s, tw, a, mult, nunits);
  else
    radix_pass<Field, 1, FROM_COMPACT>(data, compact, m_log, s, tw, a, mult,
                                       nunits);
}

template <typename Field>
__device__ __forceinline__ void run_pass(int R, bool from_compact,
                                         typename Field::T* data,
                                         const typename Field::T* compact,
                                         int m_log, int s,
                                         const typename Field::T* tw, int a,
                                         int mult, int positions) {
  const int nunits = positions >> R;
  if (from_compact)
    run_pass_from<Field, true>(R, data, compact, m_log, s, tw, a, mult, nunits);
  else
    run_pass_from<Field, false>(R, data, compact, m_log, s, tw, a, mult, nunits);
}

// Rows (batch, 2^n_log) of `in` (only the first 2^(n_log - r) entries of
// a row read) -> their NTTs in `out`.  tw[(1 << s) - 1 + k] = w_{2^(s+1)}^k.
// Needs n_log - c_log > r when c_log > 0, L / C >= 4, and at most
// Field::MAX_XCHG 16-byte words of exchange a thread.
template <typename Field>
__device__ void ntt_cluster_body(typename Field::T* smem,
                                 const typename Field::T* __restrict__ in,
                                 typename Field::T* __restrict__ out,
                                 const typename Field::T* __restrict__ tw,
                                 long long batch, int n_log, int c_log, int r) {
  using T = typename Field::T;
  constexpr int W4 = 16 / sizeof(T);    // words of a 16-byte access
  cg::cluster_group cluster = cg::this_cluster();
  const int l_log = n_log - c_log;      // positions of a block
  const int lc_log = l_log - c_log;     // of a block's lo range
  const int L = 1 << l_log, Lc = 1 << lc_log;
  const int m_log = l_log - r;          // compact positions of a block
  const int rank = c_log ? int(cluster.block_rank()) : 0;
  T* data = smem;
  T* compact = data + L;
  T* twl = compact + (L >> r);
  T* twh = twl + L;
  for (int i = threadIdx.x; i < L - 1; i += blockDim.x) twl[i] = tw[i];
  for (int t = 0; t < c_log; ++t) {   // hi stage t: k = (hi mod 2^t) L + lo
    const T* row = tw + ((1LL << (l_log + t)) - 1) + rank * Lc;
    T* dst = twh + ((1 << t) - 1) * Lc;
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
    const T* src = in + row * n;
    __syncthreads();   // the last row's store has read `data`
    for (int j = threadIdx.x; j < (1 << m_log); j += blockDim.x)
      compact[swz<T>(int(rev_bits(uint32_t(j), m_log)), m_log)] =
          src[((long long)j << c_log) | rrank];
    __syncthreads();
    if (r == l_log) {   // r == n_log: every output is the one coefficient
      for (int e = threadIdx.x; e < L; e += blockDim.x) data[e] = compact[0];
      __syncthreads();
    }
    // stages r .. l_log - 1 on lo, up to MAX_R a pass, the first from the
    // compact buffer
    for (int s = r; s < l_log;) {
      const int R = l_log - s < Field::MAX_R ? l_log - s : Field::MAX_R;
      run_pass<Field>(R, s == r, data, compact, m_log, s, twl, s, 1, L);
      s += R;
      __syncthreads();
    }
    if (c_log) {
      // block b sends (b, lo) to block lo >> lc_log, at b Lc + lo mod Lc
      uint4 v[Field::MAX_XCHG];
      uint4* data4 = reinterpret_cast<uint4*>(data);
#pragma unroll
      for (int u = 0; u < Field::MAX_XCHG; ++u) {
        const int i = threadIdx.x + u * blockDim.x;
        if (i < L / W4) v[u] = data4[i];
      }
      cluster.sync();
#pragma unroll
      for (int u = 0; u < Field::MAX_XCHG; ++u) {
        const int i = threadIdx.x + u * blockDim.x;
        if (i < L / W4) {
          const int lo = W4 * i;
          uint4* dst = reinterpret_cast<uint4*>(
              cluster.map_shared_rank(data, lo >> lc_log));
          dst[(rank * Lc + (lo & (Lc - 1))) / W4] = v[u];
        }
      }
      cluster.sync();
      // stages on hi, local now: stage t is local stage lc_log + t
      for (int t = 0; t < c_log;) {
        const int R = c_log - t < Field::MAX_R ? c_log - t : Field::MAX_R;
        run_pass<Field>(R, false, data, compact, m_log, lc_log + t, twh, t, Lc,
                        L);
        t += R;
        __syncthreads();
      }
    }
    // local index e = hi Lc + lo' is position hi L + rank Lc + lo'
    if (L < 4) {        // a row of one or two (one block)
      for (int e = threadIdx.x; e < L; e += blockDim.x)
        out[row * n + e] = Field::canon(data[e]);
      continue;
    }
    const uint4* data4 = reinterpret_cast<const uint4*>(data);
    uint4* dst4 = reinterpret_cast<uint4*>(out + row * n);
    for (int i = threadIdx.x; i < L / W4; i += blockDim.x) {
      const int e = W4 * i;
      uint4 v = data4[i];
      T* w = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int k = 0; k < W4; ++k) w[k] = Field::canon(w[k]);
      dst4[(((long long)(e >> lc_log) << l_log) + rank * Lc + (e & (Lc - 1))) / W4] =
          v;
    }
  }
}

template <typename Field>
__global__ void __launch_bounds__(Field::MAX_THREADS, Field::MIN_BLOCKS)
cluster_kernel(const typename Field::T* __restrict__ in,
               typename Field::T* __restrict__ out,
               const typename Field::T* __restrict__ tw, long long batch,
               int n_log, int c_log, int r) {
  ntt_cluster_body<Field>(reinterpret_cast<typename Field::T*>(ntt_smem), in,
                          out, tw, batch, n_log, c_log, r);
}

// y[(rev_m(i) << r) + t] = x[i] for i < 2^m, t < 2^r, m = n_log - r >= 10:
// with i = (a, mid, c), a and c of 5 bits, rev_m(i) = (rev c, rev mid,
// rev a); a block takes one (row, mid) and its 32 x 32 (a, c) tile, read
// along c and written along rev a.
template <typename T>
__global__ void __launch_bounds__(256)
bitrev_kernel(const T* __restrict__ in, T* __restrict__ out, int n_log,
              int r) {
  __shared__ T tile[32][33];
  const int m_log = n_log - r;
  const int mid_log = m_log - 10;
  const long long row = blockIdx.x >> mid_log;
  const uint32_t mid = blockIdx.x & ((1u << mid_log) - 1);
  const T* src = in + (row << n_log);
  T* dst = out + (row << n_log);
  const int tx = threadIdx.x & 31;
  for (int ty = threadIdx.x >> 5; ty < 32; ty += blockDim.x >> 5)
    tile[ty][tx] = src[((long long)ty << (m_log - 5)) | (mid << 5) | tx];
  __syncthreads();
  const uint32_t rmid = rev_bits(mid, mid_log);
  for (int ty = threadIdx.x >> 5; ty < 32; ty += blockDim.x >> 5) {
    const T v = tile[rev_bits(tx, 5)][rev_bits(ty, 5)];
    const long long o = ((long long)ty << (m_log - 5)) | (rmid << 5) | tx;
    for (int t = 0; t < (1 << r); ++t) dst[(o << r) + t] = v;
  }
}

// -- host side ----------------------------------------------------------

inline cudaLaunchConfig_t cluster_config(int c_log, int threads, int clusters,
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

template <typename Field>
void configure() {
  static bool done = false;
  if (!done) {
    cudaFuncSetAttribute(cluster_kernel<Field>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    cudaFuncSetAttribute(cluster_kernel<Field>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    done = true;
  }
}

// Clusters of this shape the card holds at once (the occupancy query,
// remembered per shape): a persistent launch takes no more, or the rest
// would wait for whole clusters to finish all their rows.
template <typename Field>
int active_clusters(int c_log, int threads, int smem) {
  static long long keys[256];
  static int counts[256];
  const long long key = ((long long)smem << 16) | (threads << 4) | c_log;
  int i = 0;
  for (; i < 256 && keys[i] != 0; ++i)
    if (keys[i] == key) return counts[i];
  configure<Field>();
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(c_log, threads, 1, smem, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, cluster_kernel<Field>, &cfg) !=
          cudaSuccess ||
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
template <typename Field>
int launch_cluster(const typename Field::T* in, typename Field::T* out,
                   const typename Field::T* tw, long long batch, int n_log,
                   int c_log, int r, int threads, int clusters, int smem,
                   void* stream) {
  using T = typename Field::T;
  if (n_log < 0 || n_log > Field::CLUSTER_MAX_LOG || c_log < 0 ||
      c_log > Field::MAX_CLUSTER_LOG || c_log > n_log - r || r < 0 ||
      threads < 32 || threads > Field::MAX_THREADS || threads % 32 ||
      clusters < 1 ||
      (c_log && (n_log - c_log <= r || n_log - 2 * c_log < 2 ||
                 (long long)sizeof(T) << (n_log - c_log) >
                     16LL * Field::MAX_XCHG * threads)) ||
      smem != (long long)sizeof(T) * smem_words(n_log, c_log, r) ||
      smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  configure<Field>();
  const int active = active_clusters<Field>(c_log, threads, smem);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(c_log, threads, clusters < active ? clusters : active, smem,
                     (cudaStream_t)stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_kernel<Field>, in,
                                             out, tw, batch, n_log, c_log, r);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int launch_bitrev(const T* in, T* out, long long batch, int n_log, int r,
                  void* stream) {
  if (n_log - r < 10 || r < 0) return (int)cudaErrorInvalidValue;
  bitrev_kernel<T><<<unsigned(batch << (n_log - r - 10)), 256, 0,
                     (cudaStream_t)stream>>>(in, out, n_log, r);
  return (int)cudaGetLastError();
}

}  // namespace ntt_cluster
