// The device transcript's two kernels, for Poseidon-GL (width 12) and
// Poseidon2-BB (width 16): one Fiat-Shamir step (transcript_flush) and the
// FRI proof-of-work grind (pow_grind).  Both run the permutation of
// poseidon_gl.cuh / poseidon2_bb.cuh, bit-exact with the hosts' permute_host.
//
// They replace no Pallas kernel.  The JAX package runs the transcript step
// as one jitted XLA program (plonky2_goldibear_tpu/hash/
// device_challenger.py:_flush_program) and the grind as one lax.while_loop
// program (fri/prover.py:_grind_async_jit); in plain torch a step would be
// several launches a permutation and the grind one host round trip a batch
// of candidates, which would break the device-transcript prover's one
// blocking fetch a proof (plonk/prover_async.py).
//
// transcript_flush: the duplex replay of the host Challenger
// (hash/challenger.py, reference iop/challenger.rs:18-160) for a static
// schedule: absorb `total` pending elements, overwriting state[0..RATE] and
// permuting at each full chunk; a final observe that fills the buffer
// refills the outputs; the partial chunk is absorbed before the first
// squeeze; n challenges are squeezed from the END of the output buffer.
// It writes the new state, the output buffer and the challenges, or the
// leftover inputs when n = 0 (grind_inputs).  The pending pieces are read
// through a pointer table (kernel parameters), so a step is one launch.
// Bound: latency.  A step is a chain of dependent permutations over one
// state, so the state is held by the group with the least latency a
// permutation: 12 threads (in a 16-thread span) for Poseidon-GL, 16 for
// Poseidon2-BB (its partial rounds take one shuffle reduction in all).
//
// pow_grind: the smallest witness w < 2^32 whose response (lane RATE - 1 of
// the permuted state, with the sponge state's first L lanes overwritten by
// the leftover inputs and w in lane L) passes: canonical value < 2^k (GL: the
// u64; BB: the canonical value of the Montgomery form).  Bound: the
// permutations of the candidates it tries, one thread a state (the permute
// kernel's group).  Blocks claim chunks of blockDim candidates in ascending
// order from an atomic counter and keep the smallest hit with an atomic max
// of ~w; a block stops once its next chunk starts above the current
// minimum.  Every chunk that starts at or below the answer was claimed
// before the answer's chunk and started below every minimum seen, so it
// was tested: the answer is the smallest passing witness, the sync
// grinder's first hit.  Past 2^32 candidates the blocks stop and the found
// flag stays 0.  The last block to finish writes the witness as a field
// element and the flag, so the result never goes through the host.
#include <cstdint>
#include <cuda_runtime.h>

#include "poseidon2_bb.cuh"
#include "poseidon_gl.cuh"

namespace {

constexpr int MAX_PIECES = 8;
constexpr int FLUSH_THREADS = 16;    // one group's span, either hasher
constexpr int GRIND_THREADS = 128;   // candidates a chunk

// The pending pieces of a step: piece k holds elements end[k - 1] ..
// end[k] - 1 of the absorbed stream.
template <class T>
struct Pieces {
  const T* ptr[MAX_PIECES];
  long long end[MAX_PIECES];
  int count;
};

template <class T>
__device__ __forceinline__ T element(const Pieces<T>& p, long long i) {
  int k = 0;
  while (k + 1 < p.count && i >= p.end[k]) ++k;
  return p.ptr[k][i - (k ? p.end[k - 1] : 0)];
}

// Poseidon-GL: a state of 12 lanes, lane q in thread q of a 12-thread
// group (16 threads: 12 .. 15 are spares copying 0 .. 3 and never write).
struct GlGroup {
  using T = uint64_t;
  static constexpr int WIDTH = poseidon_gl::WIDTH, RATE = poseidon_gl::RATE;
  poseidon_gl::Member<12> m;
  __device__ __forceinline__ explicit GlGroup(int t) : m(t) {}
  __device__ __forceinline__ int lane() const { return m.q; }
  __device__ __forceinline__ bool writer() const { return !m.spare; }
  __device__ __forceinline__ void permute(T& x) const {
    T s[1] = {x};
    poseidon_gl::permute<12>(s, m.q, m.mask, nullptr);
    x = s[0];
  }
};

// Poseidon2-BB: a state of 16 lanes, lane q in thread q.
struct BbGroup {
  using T = uint32_t;
  static constexpr int WIDTH = poseidon2_bb::WIDTH, RATE = poseidon2_bb::RATE;
  poseidon2_bb::Member<16> m;
  poseidon2_bb::Consts<16> c;
  __device__ __forceinline__ explicit BbGroup(int t) : m(t), c(m.q) {}
  __device__ __forceinline__ int lane() const { return m.q; }
  __device__ __forceinline__ bool writer() const { return true; }
  __device__ __forceinline__ void permute(T& x) const {
    T s[1] = {x};
    poseidon2_bb::permute<16>(s, m.q, m.mask, c);
    x = s[0];
  }
};

// One transcript step; dst = new state (WIDTH) | output buffer (RATE) |
// challenges (n), or the leftover inputs when n = 0.
template <class H>
__global__ void flush_kernel(const typename H::T* __restrict__ state,
                             const typename H::T* __restrict__ out_buf,
                             Pieces<typename H::T> pieces, long long total,
                             int n_out, int n, typename H::T* dst) {
  using T = typename H::T;
  constexpr int W = H::WIDTH, R = H::RATE;
  const H h(threadIdx.x);
  const int lane = h.lane();
  T s = state[lane];
  T o = lane < R ? out_buf[lane] : 0;
  long long pos = 0;
  const long long n_full = total / R;
  for (long long k = 0; k < n_full; ++k, pos += R) {
    if (lane < R) s = element(pieces, pos + lane);
    h.permute(s);
  }
  int leftover = int(total - pos);
  int cur;
  if (total && leftover == 0) {   // the last observe duplexed: refilled
    o = s;
    cur = R;
  } else {
    cur = total ? 0 : n_out;
  }
  T* out = dst + W + R;
  for (int i = 0; i < n; ++i) {
    if (leftover || cur == 0) {
      if (leftover && lane < leftover) s = element(pieces, pos + lane);
      leftover = 0;
      h.permute(s);
      o = s;
      cur = R;
    }
    if (h.writer() && lane == cur - 1) out[i] = o;
    --cur;
  }
  if (!h.writer()) return;
  if (n == 0 && lane < leftover) out[lane] = element(pieces, pos + lane);
  dst[lane] = s;
  if (lane < R) dst[W + lane] = o;
}

template <class T>
int flush(const T* state, const T* out_buf, const void* const* ptrs,
          const long long* ends, int count, long long total, int n_out, int n,
          T* dst, void* stream, void (*kernel)(const T*, const T*, Pieces<T>,
                                               long long, int, int, T*)) {
  if (count < 0 || count > MAX_PIECES || total < 0 || n < 0 || n_out < 0)
    return (int)cudaErrorInvalidValue;
  Pieces<T> p{};
  for (int k = 0; k < count; ++k) {
    p.ptr[k] = static_cast<const T*>(ptrs[k]);
    p.end[k] = ends[k];
  }
  p.count = count;
  kernel<<<1, FLUSH_THREADS, 0, (cudaStream_t)stream>>>(state, out_buf, p,
                                                        total, n_out, n, dst);
  return (int)cudaGetLastError();
}

// The grind's field: a candidate as a field element, the response test.
struct GlField {
  using T = uint64_t;
  static constexpr int WIDTH = poseidon_gl::WIDTH, RATE = poseidon_gl::RATE;
  static constexpr T ONE = 1;
  __device__ __forceinline__ static T from_u32(uint64_t w) { return w; }
  __device__ __forceinline__ static bool passes(T resp, int k) {
    return k >= 64 || resp < (1ull << k);
  }
};

struct BbField {
  using T = uint32_t;
  static constexpr int WIDTH = poseidon2_bb::WIDTH, RATE = poseidon2_bb::RATE;
  static constexpr T ONE = 0x0ffffffeu;          // 2^32 mod p
  static constexpr uint32_t R2 = 0x45dddde3u;    // 2^64 mod p
  __device__ __forceinline__ static T from_u32(uint64_t w) {
    return bb::redc(w * R2);                     // w < 2^32: < p 2^32
  }
  __device__ __forceinline__ static bool passes(T resp, int k) {
    return k >= 31 || bb::redc(resp) < (1u << k);
  }
};

// The permutation of one state in one thread, with what it needs set up
// once a block (GL: the doubled round constants in shared memory).
struct GlOne {
  const uint32_t* rc2;
  __device__ __forceinline__ explicit GlOne(uint4* smem)
      : rc2(poseidon_gl::rc2_to_shared<1>(smem)) {}
  __device__ __forceinline__ void operator()(uint64_t s[]) const {
    poseidon_gl::permute<1>(s, 0, 0, rc2);
  }
};

struct BbOne {
  __device__ __forceinline__ explicit BbOne(uint4*) {}
  __device__ __forceinline__ void operator()(uint32_t s[]) const {
    poseidon2_bb::permute<1>(s, 0, 0, poseidon2_bb::Consts<1>(0));
  }
};

// scratch: [0] chunks claimed, [1] ~(least witness found) or 0, [2] blocks
// done, [3] chunks tested; zeroed before the launch.  out: the witness as a
// field element (0 when none) and the found flag (1 or 0, field elements).
template <class Fd, class One, int SMEM>
__global__ void grind_kernel(const typename Fd::T* __restrict__ state,
                             const typename Fd::T* __restrict__ leftover,
                             int L, int k, unsigned long long* scratch,
                             typename Fd::T* out) {
  using T = typename Fd::T;
  constexpr int W = Fd::WIDTH;
  __shared__ uint4 smem[SMEM];
  __shared__ unsigned long long start;
  const One permute(smem);
  T base[W];
#pragma unroll
  for (int i = 0; i < W; ++i) base[i] = i < L ? leftover[i] : state[i];
  constexpr unsigned long long STOP = ~0ull;
  while (true) {
    if (threadIdx.x == 0) {
      const unsigned long long c = atomicAdd(scratch, 1ull) * blockDim.x;
      const unsigned long long best = ~atomicAdd(scratch + 1, 0ull);
      start = c >= (1ull << 32) || c > best ? STOP : c;
    }
    __syncthreads();
    const unsigned long long c = start;
    __syncthreads();             // every thread has read it before the next
    if (c == STOP) break;
    const unsigned long long w = c + threadIdx.x;
    T s[W];
#pragma unroll
    for (int i = 0; i < W; ++i) s[i] = i == L ? Fd::from_u32(w) : base[i];
    permute(s);
    if (Fd::passes(s[Fd::RATE - 1], k)) atomicMax(scratch + 1, ~w);
    if (threadIdx.x == 0) atomicAdd(scratch + 3, 1ull);
  }
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(scratch + 2, 1ull) == gridDim.x - 1) {
      const unsigned long long best = atomicAdd(scratch + 1, 0ull);
      out[0] = best ? Fd::from_u32(~best) : 0;
      out[1] = best ? Fd::ONE : 0;
    }
  }
}

template <class Fd, class One, int SMEM>
int grind(const typename Fd::T* state, const typename Fd::T* leftover, int L,
          int k, int blocks, unsigned long long* scratch,
          typename Fd::T* out, void* stream) {
  if (L < 0 || L >= Fd::RATE || (L > 0 && leftover == nullptr) || k < 0 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, 4 * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  grind_kernel<Fd, One, SMEM><<<blocks, GRIND_THREADS, 0, st>>>(
      state, leftover, L, k, scratch, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int transcript_set_constants_gl(const uint64_t* rc) {
  return poseidon_gl::set_constants(rc);
}

// the arguments of poseidon2_bb_set_constants (csrc/poseidon2_bb.cu)
extern "C" int transcript_set_constants_bb(const uint32_t* ext_rc,
                                           const uint32_t* int_rc,
                                           const uint32_t* scale,
                                           const uint32_t* scaled_diag,
                                           const uint32_t* diag_pows,
                                           const uint32_t* diag_pow_sums) {
  return poseidon2_bb::set_constants(ext_rc, int_rc, scale, scaled_diag,
                                     diag_pows, diag_pow_sums);
}

extern "C" int transcript_max_pieces() { return MAX_PIECES; }

// ptrs, ends: `count` pending pieces and their cumulative end offsets
// (host arrays); dst: WIDTH + RATE + max(n, leftover) elements.
extern "C" int transcript_flush_gl(const uint64_t* state,
                                   const uint64_t* out_buf,
                                   const void* const* ptrs,
                                   const long long* ends, int count,
                                   long long total, int n_out, int n,
                                   uint64_t* dst, void* stream) {
  return flush<uint64_t>(state, out_buf, ptrs, ends, count, total, n_out, n,
                         dst, stream, flush_kernel<GlGroup>);
}

extern "C" int transcript_flush_bb(const uint32_t* state,
                                   const uint32_t* out_buf,
                                   const void* const* ptrs,
                                   const long long* ends, int count,
                                   long long total, int n_out, int n,
                                   uint32_t* dst, void* stream) {
  return flush<uint32_t>(state, out_buf, ptrs, ends, count, total, n_out, n,
                         dst, stream, flush_kernel<BbGroup>);
}

// state: WIDTH elements; leftover: L < RATE elements (null when L = 0);
// blocks of GRIND_THREADS threads; scratch: 4 words; out: 2 elements.
extern "C" int pow_grind_gl(const uint64_t* state, const uint64_t* leftover,
                            int L, int k, int blocks,
                            unsigned long long* scratch, uint64_t* out,
                            void* stream) {
  return grind<GlField, GlOne, poseidon_gl::RC2_WORDS / 4>(
      state, leftover, L, k, blocks, scratch, out, stream);
}

extern "C" int pow_grind_bb(const uint32_t* state, const uint32_t* leftover,
                            int L, int k, int blocks,
                            unsigned long long* scratch, uint32_t* out,
                            void* stream) {
  return grind<BbField, BbOne, 1>(state, leftover, L, k, blocks, scratch,
                                  out, stream);
}

extern "C" int pow_grind_threads() { return GRIND_THREADS; }
