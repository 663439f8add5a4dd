// HyperLogLog register kernels for Hopper (sm_90a): the batched insert
// (scatter-max) and the per-row cardinality estimate of a pool of dense
// int8[S, m] register rows, m = 2^p, p = 4..18.
//
// hll_insert replaces veneur_tpu/ops/hll.py insert_batch (an XLA program:
// sort by slot, scatter-max of the run ends), hll_estimate replaces
// veneur_tpu/ops/hll.py estimate (an XLA program: exp2(-rank) table gather,
// adjacent-pair halving tree, zero count, linear counting). Neither was a
// Pallas kernel; both are the set path's only device work.
//
// hll_insert. Each update is one packed 8-byte record, int32 row and
// uint32 register | (uint8) rank << 24 (register < 2^24; p <= 18 needs
// 18 bits). flat = row * m + register in 64 bits; a flat slot in
// [-S * m, -1] wraps once to flat + S * m, as the reference's device
// program indexes (jnp), and every other slot outside [0, S * m) is
// dropped (its mode="drop"). The byte is raised to max(old, rank) as a
// signed int8 (a rank-0 update still lifts a negative register to 0).
//
// Bound: at the main path's 16,384 updates the kernel moves 8 B per
// record and a read and a write of each register it touches, about
// 0.16 MB, which the card's memory moves in 0.05 us; what it costs is
// latency: the launch, the record load, then a dependent load and an
// atomicCAS on a random word of a pool far larger than the 50 MB L2.
// So the design cuts the number and the depth of those round trips:
//   * One record load per update (8 B, coalesced), not three.
//   * Warp aggregation. Lanes whose updates fall in the same 32-bit word
//     find each other with __match_any_sync. Each lane builds a word with
//     its rank in its byte and 0x80 (-128, the identity of signed max) in
//     the other three; the lowest lane of each group (its leader) takes
//     the others' words by shuffles and combines them with __vmaxs4, the
//     per-byte signed max. One leader per distinct word then loads the
//     word and runs the CAS loop on __vmaxs4(old, mine), skipping it when
//     that equals old. Registers only grow, so even a stale old makes the
//     skip safe.
//   * One update a thread, every block queued. Several updates per
//     thread with their word loads issued before any CAS, and first
//     attempts as CASes that guess a zero word, were built and measured
//     slower on the H100 at 1,048,576 updates and level at 16,384
//     (tools/port_probe_hll.py, PERF.md), so neither is kept.
//   * 128-thread blocks, so 16,384 updates spread over 128 blocks, one
//     per SM, where 256-thread blocks left half the SMs idle.
// Signed max is order-free and associative, so whatever order the
// updates land in the pool is bytewise the plain version's.
//
// hll_estimate. Per row: inv_sum = the sum of 2^-register in the
// reference's association (exactnum.tsum: adjacent pairs, then pairs of
// pairs, zero-padded to a power of two; m is one), zeros = the number of
// zero registers (int32), raw = alpha_m2 / inv_sum (IEEE division),
// linear = linear_table[zeros], out = (raw <= 2.5m && zeros > 0) ? linear
// : raw. One instance per precision, so every shape below is known at
// compile time. A team of G = min(256, m / 16) threads takes one row
// (256 / G rows per block); blocks are persistent (as many as the SMs hold)
// and stride over the rows, building the byte table once. Thread t of a
// team reads the aligned contiguous run of 16 * nc registers at t * 16 * nc
// (nc = m / 16G) with 16-byte loads, up to four in flight, maps each byte
// through a 256-entry f32 table in shared memory, sums each 16-register
// load as a pairwise tree, each group of loads likewise, and the groups'
// sums likewise, so its partial is the halving tree's node over its run
// (all trees unrolled at compile time, in registers).
// The team then combines partials with __shfl_down_sync by 1, 2, 4, 8, 16
// (lane t adds lane t + d when t is a multiple of 2d) and, for G > 32,
// through shared memory in the same pattern: every addition pairs two
// aligned power-of-two blocks of registers, as the reference's tree does,
// and f32 addition is commutative, so the sum is the reference's bit for
// bit. The byte table is built per block from the 65-entry exp2(-rank)
// table the wrapper passes (exactnum.exp2_neg_table(), the reference's
// bits): byte b is the register value (int8)b, and the reference's gather
// ept[r] wraps a negative r once (r + 65) and clamps into [0, 64]. Bound:
// reading S * m bytes once (512 MiB at S = 32,768, p = 14: 0.16 ms at
// 3.35 TB/s); per register the kernel spends a byte extract, one shared
// load and one add, so the instruction stream is about as long as the
// read.
//
// Built with -fmad=false and without fast math (no contraction; the
// division is correctly rounded).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInsertThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// one record: its word index and its word (the rank in its byte, 0x80 in
// the other three); false when the update is dropped
__device__ __forceinline__ bool decode(const int2 rec, long long total,
                                       int m, long long& word,
                                       unsigned& mine) {
  const unsigned hi = (unsigned)rec.y;
  long long flat = (long long)rec.x * m + (long long)(hi & 0xffffffu);
  if (flat < 0) flat += total;
  if (flat < 0 || flat >= total) return false;
  const int sh = (int)(flat & 3) * 8;
  word = flat >> 2;
  mine = (0x80808080u & ~(0xffu << sh)) | ((hi >> 24) << sh);
  return true;
}

__global__ void __launch_bounds__(kInsertThreads)
    hll_insert_kernel(unsigned* words, const int2* recs, long long n,
                      long long total, int m) {
  const long long i = (long long)blockIdx.x * kInsertThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // a whole warp past n leaves together; the warp that straddles n keeps
  // its idle lanes for the full-mask collectives below
  if (i - lane >= n) return;
  unsigned mine = 0x80808080u;
  long long word = 0;
  const bool valid = i < n && decode(__ldg(recs + i), total, m, word, mine);
  // a dropped update keys on a value no word index takes, distinct per
  // lane, so it matches no one
  const unsigned long long key =
      valid ? (unsigned long long)word : ~0ull - (unsigned)lane;
  const unsigned peers = __match_any_sync(kFull, key);
  // the leader (lowest lane) takes each other peer's word in turn; the
  // warp runs as many rounds as its largest group needs
  unsigned agg = mine;
  unsigned rest = peers & (peers - 1);
  const int rounds = (int)__reduce_max_sync(kFull, __popc(peers)) - 1;
  for (int t = 0; t < rounds; ++t) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1;
    agg = __vmaxs4(agg, __shfl_sync(kFull, mine, src));
  }
  if (!valid || lane != __ffs(peers) - 1) return;
  // one leader per distinct word: load it and, unless max leaves it as
  // it is, CAS until the word holds the max
  unsigned cur = *reinterpret_cast<volatile unsigned*>(words + word);
  for (;;) {
    const unsigned want = __vmaxs4(cur, agg);
    if (want == cur) break;
    const unsigned seen = atomicCAS(words + word, cur, want);
    if (seen == cur) break;
    cur = seen;
  }
}

// an empty kernel: the launch floor the insert is measured against
__global__ void hll_noop_kernel() {}

// adjacent-pair halving tree over N values (N a power of two), unrolled
// at compile time so the values stay in registers
template <int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    float h[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = v[2 * i] + v[2 * i + 1];
    return tree_sum<N / 2>(h);
  }
}

// the 16 registers of one 16-byte load: register 4 * w + b is byte b of
// word w; their table values as a pairwise tree
__device__ __forceinline__ float load_sum(const uint4 v, const float* tab) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
  float x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = tab[(w[i / 4] >> (8 * (i % 4))) & 0xffu];
  return tree_sum<16>(x);
}

__device__ __forceinline__ int zero_bytes(const uint4 v) {
  return (__popc(__vcmpeq4(v.x, 0u)) + __popc(__vcmpeq4(v.y, 0u)) +
          __popc(__vcmpeq4(v.z, 0u)) + __popc(__vcmpeq4(v.w, 0u))) >> 3;
}

template <int P>
struct EstimateCfg {
  static constexpr int M = 1 << P;                    // registers per row
  static constexpr int G = M / 16 < 256 ? M / 16 : 256;  // threads per row
  static constexpr int NC = M / (16 * G);  // 16-byte loads per thread
  static constexpr int B = NC < 4 ? NC : 4;  // loads in flight per thread
  static constexpr int NG = NC / B;          // groups of B loads
  static constexpr int kRows = kThreads / G;  // rows per block
  static constexpr int kTeamLanes = G < 32 ? G : 32;
  static constexpr int kTeamWarps = G > 32 ? G / 32 : 1;
  static_assert(P >= 4 && P <= 18, "precision 4..18");
  static_assert(NG <= 16, "at most 16 groups a thread");
};

template <int P>
__global__ void __launch_bounds__(kThreads)
    hll_estimate_kernel(const unsigned char* regs, const float* ept65,
                        const float* linear, float* out, int S,
                        float alpha_m2, float thresh) {
  using C = EstimateCfg<P>;
  __shared__ float tab[256];
  __shared__ float wsum[kThreads / 32];
  __shared__ int wzero[kThreads / 32];

  for (int b = threadIdx.x; b < 256; b += kThreads) {
    int r = (int)(signed char)b;
    if (r < 0) r += 65;
    r = r < 0 ? 0 : (r > 64 ? 64 : r);
    tab[b] = ept65[r];
  }
  __syncthreads();

  const int team = threadIdx.x / C::G;
  const int t = threadIdx.x % C::G;
  const int warp = threadIdx.x >> 5;
  // persistent blocks: the row loop is uniform over the block
  for (long long row0 = (long long)blockIdx.x * C::kRows; row0 < S;
       row0 += (long long)gridDim.x * C::kRows) {
    const long long row = row0 + team;
    const bool live = row < S;
    float acc = 0.0f;
    int zeros = 0;
    if (live) {
      const uint4* src =
          reinterpret_cast<const uint4*>(regs + row * C::M) + t * C::NC;
      // one partial per group of B loads, then their tree
      float gs[C::NG];
#pragma unroll
      for (int g = 0; g < C::NG; ++g) {
        uint4 v[C::B];
#pragma unroll
        for (int i = 0; i < C::B; ++i) v[i] = __ldg(src + g * C::B + i);
        float xs[C::B];
#pragma unroll
        for (int i = 0; i < C::B; ++i) {
          zeros += zero_bytes(v[i]);
          xs[i] = load_sum(v[i], tab);
        }
        gs[g] = tree_sum<C::B>(xs);
      }
      acc = tree_sum<C::NG>(gs);
    }
    // lanes of a team: lane t adds lane t + d for d = 1, 2, 4, 8, 16
#pragma unroll
    for (int d = 1; d < C::kTeamLanes; d <<= 1) {
      const float o = __shfl_down_sync(kFull, acc, d);
      const int oz = __shfl_down_sync(kFull, zeros, d);
      acc = acc + o;
      zeros += oz;
    }
    if constexpr (C::kTeamWarps > 1) {
      if ((threadIdx.x & 31) == 0) {
        wsum[warp] = acc;
        wzero[warp] = zeros;
      }
      __syncthreads();
      if (t == 0) {
        float s[C::kTeamWarps];
        zeros = 0;
#pragma unroll
        for (int i = 0; i < C::kTeamWarps; ++i) {
          s[i] = wsum[warp + i];
          zeros += wzero[warp + i];
        }
        acc = tree_sum<C::kTeamWarps>(s);
      }
      __syncthreads();  // the next row's partials overwrite wsum
    }
    if (t == 0 && live) {
      const float raw = alpha_m2 / acc;
      const float lin = __ldg(linear + zeros);
      out[row] = (raw <= thresh && zeros > 0) ? lin : raw;
    }
  }
}

template <int P>
cudaError_t launch_estimate(const void* regs, const void* ept65,
                            const void* linear, void* out, int S,
                            float alpha_m2, float thresh,
                            cudaStream_t stream) {
  using C = EstimateCfg<P>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hll_estimate_kernel<P>, kThreads, 0);
  if (e != cudaSuccess) return e;
  const long long blocks = ((long long)S + C::kRows - 1) / C::kRows;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(blocks < cap ? blocks : cap);
  hll_estimate_kernel<P><<<grid, kThreads, 0, stream>>>(
      (const unsigned char*)regs, (const float*)ept65, (const float*)linear,
      (float*)out, S, alpha_m2, thresh);
  return cudaGetLastError();
}

}  // namespace

// Scatter-max the n packed records (int2: row, register | rank << 24)
// into the int8 pool of `total` = S * m bytes on `stream`, one update a
// thread; returns cudaGetLastError(). The wrapper has checked types,
// contiguity, the pool's 16-byte alignment, the records' 8-byte
// alignment and m = 2^p, 4 <= p <= 18.
extern "C" int hll_insert_launch(void* regs, const void* recs, long long n,
                                 long long total, int m, void* stream) {
  if (n <= 0) return 0;
  if (m < 16 || (m & (m - 1))) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kInsertThreads - 1) / kInsertThreads;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  hll_insert_kernel<<<(unsigned)blocks, kInsertThreads, 0,
                      (cudaStream_t)stream>>>(
      (unsigned*)regs, (const int2*)recs, n, total, m);
  return (int)cudaGetLastError();
}

// The empty kernel at `grid` blocks of the insert's block size.
extern "C" int hll_noop_launch(int grid, void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  hll_noop_kernel<<<grid, kInsertThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int hll_insert_threads_per_block() { return kInsertThreads; }

// Estimate every row of the int8[S, 2^p] pool into f32[S] on `stream`;
// `ept65` is f32[65] (exp2(-r)), `linear` f32[2^p + 1] (m ln(m / z)), both
// on the card; `thresh` is 2.5m as f32. Returns cudaGetLastError().
extern "C" int hll_estimate_launch(const void* regs, const void* ept65,
                                   const void* linear, void* out, int S,
                                   int p, float alpha_m2, float thresh,
                                   void* stream) {
  if (S <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define HLL_ESTIMATE_CASE(P)                                               \
  case P:                                                                  \
    return (int)launch_estimate<P>(regs, ept65, linear, out, S, alpha_m2,  \
                                   thresh, st);
  switch (p) {
    HLL_ESTIMATE_CASE(4)
    HLL_ESTIMATE_CASE(5)
    HLL_ESTIMATE_CASE(6)
    HLL_ESTIMATE_CASE(7)
    HLL_ESTIMATE_CASE(8)
    HLL_ESTIMATE_CASE(9)
    HLL_ESTIMATE_CASE(10)
    HLL_ESTIMATE_CASE(11)
    HLL_ESTIMATE_CASE(12)
    HLL_ESTIMATE_CASE(13)
    HLL_ESTIMATE_CASE(14)
    HLL_ESTIMATE_CASE(15)
    HLL_ESTIMATE_CASE(16)
    HLL_ESTIMATE_CASE(17)
    HLL_ESTIMATE_CASE(18)
  }
#undef HLL_ESTIMATE_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int hll_threads_per_block() { return kThreads; }
