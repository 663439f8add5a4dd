// t-digest fold kernels for Hopper (sm_90a): K2a, the per-row compression
// of candidate centroid rows [S, M] -> [S, C], K2b, the spill fold of a
// raw-sample batch into digest rows (add_batch), its sort included, and
// K3, the staged fold of a staged plane into the pool (K2a's row routine
// behind the plane's load and the row stats).
//
// K2a replaces veneur_tpu/ops/tdigest.py _compress_rows (:142-197), K2b
// replaces add_batch (:224-353); both are jitted XLA programs there, not
// Pallas kernels, and ops/tdigest.py of the port keeps their plain
// PyTorch versions (_compress_rows_plain, add_batch_plain). The contract
// is bitwise: every output equals the plain version's on the same inputs,
// on the card, which equals the reference's on the CPU.
//
// The row routine (row_compress), shared by K2a and K2b. A group of g
// warps works on one row of n candidates, P = 256 g >= n sort lanes, 8
// keys a thread in blocked order (key i in thread i / 8, register i % 8).
// For n <= 256 the group is one warp, and a block holds 8 rows, one a
// warp: every sort stage and scan step is a register compare or a warp
// shuffle, with no block barrier. For 256 < n <= 4,096 the group is the
// block: only the bitonic stages whose partner lies in another warp, and
// the scan steps whose shift reaches past a warp's 256 keys, go through
// shared memory with a barrier. Per row, the reference's steps:
//   1. zero-weight slots keyed +inf; a stable sort by mean, the weights
//      carried (a bitonic network on the 64-bit key (order key, slot),
//      unique keys, so the network's order is the stable one). Where the
//      candidates are sorted runs -- digest rows of C slots side by side
//      (C a power of two: the pool merges, an import of whole digests,
//      K2b's row beside its batch digest), or [0, C) and [C, n) -- the
//      odd runs placed reversed stand as the network's own state, and it
//      starts at the merges of 2C keys (or runs its last merge alone);
//   2. Hillis-Steele inclusive scans of the weights and of the flushed
//      mean * weight over the n slots, in the reference's association: a
//      warp holds its 256 keys and the 256 before them (the halo), so
//      every shift below 256 is a register step or a shuffle;
//   3. q_left = (w_cum - w) / max(total, 1e-30);
//   4. the bucket: searchsorted(right) over the f32 table of the floor(d)
//      k1 boundaries (exactnum.kscale_boundaries, in shared memory once a
//      block), clipped to C - 1;
//   5. at each run end (bucket != next bucket, the row end included) the
//      run's sums as differences against the previous run end
//      (segments.last_marked_carry: a warp scan of "the last end so far",
//      a select, exact in any order), the run's mean a division;
//   6. a second stable sort by mean; the first C slots are the row.
//      Where the finite run means are nondecreasing in slot order (as a
//      rule), that sort is a stable partition (finite, +inf, NaN) that a
//      warp's counts place; else the bitonic network.
// Both shortcuts are checked on the data each time (a ballot), and give
// the network's order exactly; the network runs wherever they do not
// hold.
// K2a (td_compress_warps for M <= 256, td_compress_wide up to 4,096):
// rows past what a block holds take td_compress_scratch, one block a row
// over a global slab with a barrier a step. td_compress_warps gives each
// warp 4 consecutive rows (1 under 32,768 rows, for more blocks) and loads
// the next with cp.async while this one sorts (two buffers a warp). Bound: bytes, S * M * 8 read and S * C * 8
// written (0.1 ms at [131,072, 192] on 3.35 TB/s).
//
// K2b, the spill fold (td_add_batch_launch), from the unsorted batch:
//   td_sort_tile: tiles of 256 samples, one a warp, sorted in registers
//     by the 96-bit key (row, order key of the flushed value, input index)
//     -- the padding samples (weight <= 0) keyed to row K -- which is
//     unique, so this is exactly the plain version's two stable sorts;
//   td_sort_merge (log2(N / 256) launches): merge-path passes over pairs
//     of sorted runs, 2,048 outputs a block from their inputs staged in
//     shared memory (a pair's first run holds the earlier samples, so the
//     merge compares (row, order key) and takes the first run on a tie);
//     the last sort launch writes the sorted rows, values, weights and raw
//     values;
//   td_scan_tile: per tile of T = min(1,024, N) samples, from a T-sample
//     halo before it, the three N-long Hillis scans of the reference's
//     _prefix_scans (w; the flushed v*w, NaN blocked to 0; the flushed w/v
//     where w > 0) over their shifts below T, the in-chunk segmented
//     Hillis scans of segments.segmented_cumsum (128-sample chunks),
//     forward over the row starts and backward (the flipped array) over
//     the row ends, and the cross-chunk carry's shifts below T / 128;
//   td_scan_step (log2 N - 10 launches): the remaining shifts of both;
//   td_add_rows: a group a digest row (a warp for C <= 128): the row
//     bounds (searchsorted), the batch stats (prefix-sum differences, min
//     and max as gathers of the raw values), each sample's bucket from its
//     segmented sums, the row's run starts (a ballot a 32 samples), the
//     [C] batch digest, then the row routine over the [2C] candidates (the
//     row and the batch digest), and the digest scalars.
// Bound: bytes, the batch's N * 12 (row, value, weight) read, the [K, C]
// rows read and written and the scalars: launches, not bytes, at these
// sizes. No step syncs with the host, and nothing but these kernels runs.
//
// K3, the staged fold (td_fold_staged_launch), replaces the reference's
// _expand_flat_planes (veneur_tpu/core/worker.py:216-240) and
// _histo_fold_staged (:245-290), jitted XLA programs; core/worker.py of
// the port keeps their plain versions. Per row of the pool, by one warp:
//   1. the candidates in shared memory: the row's C means and weights in
//      slots [0, C), its B staged slots in [C, C + B), from a compacted
//      flat plane (each row's first sample from offsets the host computed
//      from the counts; with unit weights each 1.0) or a dense [R, B]
//      plane (rows at or past R empty: a mirror the directory outgrew);
//      a slot past the row's count holds 0.0 and weight 0.0. No [S, B]
//      plane and no [S, C + B] concatenation is written to device memory.
//      td_fold_warps (C + B <= 256) keeps K2a's cp.async double buffer:
//      the next row loads while this one is folded;
//   2. the row's stats from those slots (stage_stats): the sums of w, of
//      v * w and of w / v over the live slots as exactnum.tsum's halving
//      trees, the min and max as int64 order keys;
//   3. K2a's row routine over the C + B candidates ([0, C) a sorted run:
//      its shortcut checks as for any row), where a sorted row places a
//      tail of at most kRankMax = 64 slots by rank (no sort: each
//      candidate's position in the stable sort from 32-bit order-key
//      counts and an upper-bound search of the row; 1.8490 -> 1.7638 ms
//      dense at [131,072, 128, 64] on an H100); the rows by path
//      into ``paths`` where a caller asks;
//   4. the C means and weights, and the 12 scalars: XLA-order min and max
//      merges and four flushed Neumaier adds (core/worker._comp_add).
// Past 256 candidates td_stage_rows does 1, 2 and 4's scalars, writing
// the [S, C + B] candidates, and K2a's block or slab kernel compresses
// them. Bound: bytes, the [S, C] rows read and written, 12 scalars a row
// read and written, the staged plane read once (dense S * B * 8; flat
// its samples, 4 or 8 bytes each, and S * 4 of offsets): 0.104 ms at
// [131,072, 128, 64] dense on 3.35 TB/s. Like K2a it is bound by the
// instructions it issues, not by bytes: the design keeps the stats to 3
// shuffle trees of 5 steps a 32-slot tile and one key reduction, in
// front of K2a's routine.
//
// Where the bits would differ unless the kernels do as the plain version
// does:
//   * Sort order. The plain version sorts by an integer order key
//     (ops/tdigest._order_key): -0.0 and +0.0 equal, every NaN equal and
//     after +inf, ties in slot order, as lax.sort and torch.sort on the CPU
//     order floats. A radix or bitonic sort on raw bits puts -0 before +0
//     and -NaN first. So the key is canonicalised (order_key) and the
//     payload and the key's own bits are carried unchanged.
//   * Hillis pad lanes. Lanes below the shift add +0.0, which turns -0.0
//     into +0.0; the scans here add it too (never skip the add).
//   * Denormal flushes. exactnum.flush_denormals of an input is a select;
//     flush() is one, on the bits (a x * 1.0f that the compiler drops does
//     not flush). Built with -ftz=true (nvcc.EXTRACT_FLAGS): every f32
//     add, mul, div, comparison, min and max reads a denormal as zero and
//     writes a denormal result as zero, as XLA on the CPU does.
//   * Division. IEEE-rounded (no fast math, -prec-div default).
//   * Products. -fmad=false: no product meets an add unrounded.
//   * The second sort is a real sort. Run means from prefix-sum
//     differences need not be monotone, and a +inf-mean live centroid
//     sorts among the +inf padding by slot.
//   * min and max. XLA on the CPU orders -0.0 below +0.0 and lets a NaN
//     operand win (exactnum.minimum / maximum); xla_min / xla_max do the
//     same (the sort's order key keeps the two zeros equal, the min and
//     max do not).
//   * NaN in clamp_min and searchsorted: clamp_min keeps a NaN; a NaN
//     quantile lands past the table (torch's upper-bound loop).
//   * K3's tree sums at a depth B that is not a power of two: tsum pads
//     to the next power p with +0.0 and pairs (2i, 2i + 1) at every
//     level. A tile's shuffle tree (lane i adds lane i + d) leaves at
//     lane 0 exactly the node over the tile's 32 slots, the pads among
//     them added as +0.0; below p = 32 it runs log2 p steps only (a
//     further step would add a +0.0 the reference never adds); the
//     tiles' nodes combine in a binary counter in the same pairs.
//   * The +0.0 pad and the sign of zero: a dead slot contributes +0.0,
//     as the reference's where(live, ..., 0.0); -0.0 + +0.0 is +0.0
//     wherever the reference adds them, and only there.
//   * w / v at v = +-0 (+-inf: live, summed) and at NaN (NaN): IEEE
//     division, the value read flushed first, the quotient flushed.
//   * A denormal weight is not live: XLA reads w > 0 of a denormal as
//     false, so every sample and weight is flushed on its read (the
//     compress reads the raw slots and flushes them itself).
//   * The flat plane's clamped gather: the reference clamps each index
//     to the flat array's last sample and masks the slots past the
//     row's count; the kernel reads only slots below the count, which lie
//     before the offsets' total, never past the flat array's end nor
//     into its padding to a power of two.
//   * The min and max of the slots: over int64 keys (exactnum's), so the
//     NaN XLA's reduction keeps is kept, whatever order the lanes meet.
//
// The kernels are written in SIMT sections (TD_SIMT { ... }: what each
// thread does) between collectives (TD_SHFL, TD_BALLOT, TD_SYNC), so the
// same source runs on the CPU: tests/test_torch_tdigest_kernel.py builds
// it with g++ under TD_EMULATE, where each section is a loop over the
// group's threads, a per-thread variable an array a thread, a shuffle a
// lane-stepped copy between those arrays and a barrier nothing (the
// sections already run in turn), and holds it, launchers included, to the
// plain version on the CPU with MXCSR flush-to-zero and
// denormals-are-zero set.

#ifndef TD_EMULATE
#include <cuda_runtime.h>
#else
#include <string.h>
#endif
#include <stdint.h>

#ifndef TD_DYNAMIC_SMEM
#define TD_DYNAMIC_SMEM(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif
#ifndef TD_LAUNCH
#define TD_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace {

// ---------------------------------------------------------------------------
// the SIMT layer: the card's threads, or their lane-stepped emulation

#ifdef TD_EMULATE
constexpr int kEmuThreads = 1024;
int td_g0 = 0, td_gn = 1;  // the threads of the group the emulation steps
#define TD_SIMT for (int t_ = td_g0; t_ < td_g0 + td_gn; ++t_)
#define TD_TID t_
#define TD_VAR(T, x) static T x[kEmuThreads]
#define TD_ARR(T, x, n) static T x[kEmuThreads][n]
#define TD_VPARAM(T, x) T* x
#define TD_APARAM(T, x, n) T (*x)[n]
#define TD_R(x) x[t_]
#define TD_U(x) x[td_g0]
#define TD_GROUP(first, count) (td_g0 = (first), td_gn = (count))
#define TD_FOR_GROUPS(grp, gsize)                                  \
  for (int grp = 0; grp < (int)blockDim.x / (gsize); ++grp)        \
    if (TD_GROUP(grp * (gsize), (gsize)), true)
// dst (each thread's) = src as the thread at `lane` of its warp holds it
#define TD_SHFL(T, dst, src, lane)                                 \
  do {                                                             \
    static T td_sh_[kEmuThreads];                                  \
    TD_SIMT {                                                      \
      const int td_from_ = (t_ & ~31) | ((lane) & 31);             \
      T td_v_;                                                     \
      {                                                            \
        const int t_ = td_from_;                                   \
        td_v_ = (src);                                             \
      }                                                            \
      td_sh_[t_] = td_v_;                                          \
    }                                                              \
    TD_SIMT { dst = td_sh_[t_]; }                                  \
  } while (0)
#define TD_BALLOT(dst, pred)                                       \
  do {                                                             \
    static unsigned td_b_[kEmuThreads / 32];                       \
    TD_SIMT { td_b_[t_ >> 5] = 0u; }                               \
    TD_SIMT { if (pred) td_b_[t_ >> 5] |= 1u << (t_ & 31); }       \
    TD_SIMT { dst = td_b_[t_ >> 5]; }                              \
  } while (0)
#define TD_SYNC() ((void)0)
#define TD_SYNCWARP() ((void)0)
inline int td_popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicMin(int* p, int v) {
  const int o = *p;
  if (v < o) *p = v;
  return o;
}
inline int atomicAdd(int* p, int v) {
  const int o = *p;
  *p = o + v;
  return o;
}
#else
#define TD_SIMT
#define TD_TID ((int)threadIdx.x)
#define TD_VAR(T, x) T x
#define TD_ARR(T, x, n) T x[n]
#define TD_VPARAM(T, x) T& x
#define TD_APARAM(T, x, n) T (&x)[n]
#define TD_R(x) x
#define TD_U(x) x
#define TD_GROUP(first, count) ((void)0)
#define TD_FOR_GROUPS(grp, gsize)                                       \
  for (int grp = (int)threadIdx.x / (gsize), td_once_ = 1; td_once_;    \
       td_once_ = 0)
#define TD_SHFL(T, dst, src, lane) dst = td_shfl((src), (lane))
#define TD_BALLOT(dst, pred) dst = __ballot_sync(0xffffffffu, (pred))
#define TD_SYNC() __syncthreads()
#define TD_SYNCWARP() __syncwarp()
__device__ __forceinline__ int td_popc(unsigned x) { return __popc(x); }
#endif
#define TD_LANE (TD_TID & 31)
// the registers of `blocks` blocks an SM must hold `threads` threads
// each (a launch past the registers is refused: 701, out of resources)
#ifdef TD_EMULATE
#define TD_BOUNDS(threads, blocks)
#else
#define TD_BOUNDS(threads, blocks) __launch_bounds__(threads, blocks)
#endif

constexpr int kE = 8;             // keys a thread
constexpr int kSpan = 32 * kE;    // keys a warp
constexpr int kMaxGroupKeys = 16 * kSpan;  // a block's widest row
constexpr int kWarps = 8;         // warps a block of one-warp groups
constexpr int kRowsPerWarp = 4;   // K2a's rows a warp, from 32,768 rows
constexpr int kTail = 128;        // keys a warp sorts 4 a lane (a tail)
// the widest tail the rank path places (wider tails up to kTail take the
// tail sort: counting costs more than the sort past 64)
constexpr int kRankMax = 64;
// warp_rank takes a lane's keys 32 at a time, and the tail's keys and the
// 256 positions' sources share the 8 kTail bytes of the tail sort's area
static_assert(kRankMax > 0 && kRankMax % 32 == 0 && kRankMax <= kTail,
              "kRankMax: a positive multiple of 32, at most kTail");
static_assert(4 * kRankMax + 256 <= 8 * kTail,
              "the rank path's keys and sources fit the tail's area");
constexpr int kChunk = 128;       // segments.CHUNK
constexpr int kScanTile = 1024;   // K2b's in-block scan tile (and its halo)
constexpr int kSortTile = 2048;   // K2b's samples sorted in a block
constexpr int kMergeOut = 512;    // K2b's merge outputs a block
constexpr float kTiny = 1e-30f;
// a block's dynamic shared memory (227 KB); rows that need more take a
// global scratch slab
constexpr size_t kMaxSmem = 232448;

struct K96 {  // the batch sort's key: (row << 32 | order key, input index)
  uint64_t hi;
  uint32_t lo;
};

__device__ __forceinline__ bool key_less(uint64_t a, uint64_t b) {
  return a < b;
}
__device__ __forceinline__ bool key_less(const K96& a, const K96& b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}

#ifndef TD_EMULATE
__device__ __forceinline__ float td_shfl(float v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}
__device__ __forceinline__ int td_shfl(int v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}
__device__ __forceinline__ unsigned td_shfl(unsigned v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}
__device__ __forceinline__ uint64_t td_shfl(uint64_t v, int lane) {
  return __shfl_sync(0xffffffffu, (unsigned long long)v, lane);
}
__device__ __forceinline__ K96 td_shfl(const K96& v, int lane) {
  K96 r;
  r.hi = __shfl_sync(0xffffffffu, (unsigned long long)v.hi, lane);
  r.lo = __shfl_sync(0xffffffffu, v.lo, lane);
  return r;
}
#endif

// a 4-byte asynchronous copy into shared memory, and its fences
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#ifdef TD_EMULATE
  *dst = *src;
#else
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifndef TD_EMULATE
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
#ifndef TD_EMULATE
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
#endif
}

// N = 2 or 4 consecutive 32-bit words from shared memory, one load
template <int N>
__device__ __forceinline__ void lds_words(const void* p, uint32_t (&o)[N]) {
#ifdef TD_EMULATE
  memcpy(o, p, 4 * N);
#else
  if constexpr (N == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  }
#endif
}

template <bool WIDE>
__device__ __forceinline__ void group_sync() {
  if (WIDE) {
    TD_SYNC();
  } else {
    TD_SYNCWARP();
  }
}

__device__ __forceinline__ float f_inf() {
  return __uint_as_float(0x7f800000u);
}

// exactnum.flush_denormals: a denormal becomes the zero of its sign; a
// select on the bits, whatever the arithmetic's mode
__device__ __forceinline__ float flush(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x7f800000u) ? x : __uint_as_float(u & 0x80000000u);
}

// torch.clamp_min(x, 1e-30): a NaN stays NaN
__device__ __forceinline__ float clamp_tiny(float x) {
  return x != x ? x : fmaxf(x, kTiny);
}

// exactnum.minimum / maximum, as XLA on the CPU computes them: the
// operands swapped where the first is negative (its sign bit), then the
// first kept if it is a NaN or the lesser (greater); so -0.0 is below
// +0.0 in either order and a NaN operand wins
__device__ __forceinline__ float xla_min(float a, float b) {
  const bool neg = __float_as_uint(a) >> 31;
  const float x = neg ? b : a, y = neg ? a : b;
  return (x != x || x < y) ? x : y;
}
__device__ __forceinline__ float xla_max(float a, float b) {
  const bool neg = __float_as_uint(a) >> 31;
  const float x = neg ? a : b, y = neg ? b : a;
  return (x != x || x > y) ? x : y;
}

// the order of ops/tdigest._order_key (there an int32 key): ascending
// as the floats sort, -0 == +0, every NaN above +inf
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  if (f != f) return 0xffffffffu;
  if ((u & 0x7fffffffu) == 0) return 0x80000000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// searchsorted(table, q, right=True): torch's upper-bound loop
__device__ __forceinline__ int upper_bound(const float* t, int len, float q) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(t[mid] > q)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// warps of the group that works on a row of n candidates
__host__ __device__ __forceinline__ int group_warps(int n) {
  const int p = pow2_at_least(n);
  return p <= kSpan ? 1 : p / kSpan;
}

// ---------------------------------------------------------------------------
// the group's sort and scans

// ascending bitonic sort of a group's 32 E g keys (unique but for the
// padding), E a thread in blocked order (g = 1: each warp of the caller's
// group sorts its own keys); stages whose partner is in
// another warp (WIDE only) exchange through sh [32 E g]. Starting at
// k0 > 2 takes the keys to be that stage's input (runs of k0 / 2 sorted,
// alternately ascending and descending)
template <class Key, bool WIDE, int E = kE>
__device__ __forceinline__ void group_sort(TD_APARAM(Key, k, E), int g,
                                           int g0, Key* sh, int k0 = 2) {
  constexpr int span = 32 * E;
  // sh holds key i at (i % E) nthr + i / E
  const int p = span * g, nthr = 32 * g;
  TD_ARR(Key, o, E);
  for (int kk = k0; kk <= p; kk <<= 1) {
    int j = kk >> 1;
    if (WIDE && j >= span) {
      TD_SIMT {
        const int gt = g == 1 ? TD_LANE : TD_TID - g0;
#pragma unroll
        for (int e = 0; e < E; ++e) sh[e * nthr + gt] = TD_R(k)[e];
      }
      TD_SYNC();
      for (; j >= span; j >>= 1) {
        TD_SIMT {
          const int gt = g == 1 ? TD_LANE : TD_TID - g0;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int i = gt * E + e;
            const Key x = TD_R(k)[e], y = sh[e * nthr + (gt ^ (j / E))];
            const bool yl = key_less(y, x);
            TD_R(k)[e] = (((i & j) == 0) == ((i & kk) == 0))
                             ? (yl ? y : x) : (yl ? x : y);
          }
        }
        TD_SYNC();
        if (j > span) {
          TD_SIMT {
            const int gt = g == 1 ? TD_LANE : TD_TID - g0;
#pragma unroll
            for (int e = 0; e < E; ++e) sh[e * nthr + gt] = TD_R(k)[e];
          }
          TD_SYNC();
        }
      }
    }
    for (; j >= E; j >>= 1) {
      const int m = j / E;
#pragma unroll
      for (int e = 0; e < E; ++e)
        TD_SHFL(Key, TD_R(o)[e], TD_R(k)[e], TD_LANE ^ m);
      TD_SIMT {
        const int gt = g == 1 ? TD_LANE : TD_TID - g0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = gt * E + e;
          const Key x = TD_R(k)[e], y = TD_R(o)[e];
          const bool yl = key_less(y, x);
          TD_R(k)[e] = (((i & j) == 0) == ((i & kk) == 0))
                           ? (yl ? y : x) : (yl ? x : y);
        }
      }
    }
    TD_SIMT {
      const int gt = g == 1 ? TD_LANE : TD_TID - g0;
#pragma unroll
      for (int jj = E / 2; jj > 0; jj >>= 1) {
        if (jj > j) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & jj) continue;
          const bool up = ((gt * E + e) & kk) == 0;
          const Key a = TD_R(k)[e], b = TD_R(k)[e | jj];
          if (key_less(b, a) == up) {
            TD_R(k)[e] = b;
            TD_R(k)[e | jj] = a;
          }
        }
      }
    }
  }
}

// the Hillis steps with shifts below min(n, 256) of two scans over a
// warp's 256 keys (x plain adds, y flushed adds), key e of lane l at
// position c0 + 8 l + e (c0 = 256 x the warp's place in the group); with
// HALO the warp also holds the 256 keys before c0 (hx, hy), so each step
// reads only registers and shuffles. A position below the shift adds
// +0.0 (the pad lanes); a halo key whose source lies before the halo is
// left wrong: no key of the warp's own reads it.
template <bool HALO>
__device__ __forceinline__ void warp_scan2(TD_APARAM(float, x, kE),
                                           TD_APARAM(float, y, kE),
                                           TD_APARAM(float, hx, kE),
                                           TD_APARAM(float, hy, kE), int n,
                                           int g0) {
  TD_ARR(float, px, kE);
  TD_ARR(float, py, kE);
  TD_ARR(float, qx, kE);
  TD_ARR(float, qy, kE);
#pragma unroll
  for (int s = 1; s < kE; s <<= 1) {
    if (s >= n) break;
    // the lane before's last s keys (lane 0: the halo's lane 31)
#pragma unroll
    for (int e = 0; e < s; ++e) {
      TD_SHFL(float, TD_R(px)[e], TD_R(x)[kE - s + e], TD_LANE - 1);
      TD_SHFL(float, TD_R(py)[e], TD_R(y)[kE - s + e], TD_LANE - 1);
      if (HALO) {
        TD_SHFL(float, TD_R(qx)[e], TD_R(hx)[kE - s + e], TD_LANE - 1);
        TD_SHFL(float, TD_R(qy)[e], TD_R(hy)[kE - s + e], TD_LANE - 1);
      }
    }
    TD_SIMT {
      const int lane = TD_LANE;
      const int c0 = ((TD_TID - g0) >> 5) * kSpan;
      float nx[kE], ny[kE], nhx[kE], nhy[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        float ax = 0.0f, ay = 0.0f, bx = 0.0f, by = 0.0f;
        if (e >= s) {
          ax = TD_R(x)[e - s];
          ay = TD_R(y)[e - s];
          if (HALO) {
            bx = TD_R(hx)[e - s];
            by = TD_R(hy)[e - s];
          }
        } else if (lane > 0) {
          ax = TD_R(px)[e];
          ay = TD_R(py)[e];
          if (HALO) {
            bx = TD_R(qx)[e];
            by = TD_R(qy)[e];
          }
        } else if (HALO) {
          ax = TD_R(qx)[e];
          ay = TD_R(qy)[e];
        }
        if (c0 + lane * kE + e < s) ax = ay = 0.0f;
        nx[e] = TD_R(x)[e] + ax;
        ny[e] = flush(TD_R(y)[e] + ay);
        if (HALO) {
          if (c0 - kSpan + lane * kE + e < s) bx = by = 0.0f;
          nhx[e] = TD_R(hx)[e] + bx;
          nhy[e] = flush(TD_R(hy)[e] + by);
        }
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        TD_R(x)[e] = nx[e];
        TD_R(y)[e] = ny[e];
        if (HALO) {
          TD_R(hx)[e] = nhx[e];
          TD_R(hy)[e] = nhy[e];
        }
      }
    }
  }
  for (int s = kE; s < kSpan && s < n; s <<= 1) {
    const int d = s / kE;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      TD_SHFL(float, TD_R(px)[e], TD_R(x)[e], TD_LANE - d);
      TD_SHFL(float, TD_R(py)[e], TD_R(y)[e], TD_LANE - d);
      if (HALO) {
        TD_SHFL(float, TD_R(qx)[e], TD_R(hx)[e], TD_LANE - d);
        TD_SHFL(float, TD_R(qy)[e], TD_R(hy)[e], TD_LANE - d);
      }
    }
    TD_SIMT {
      const int lane = TD_LANE;
      const int c0 = ((TD_TID - g0) >> 5) * kSpan;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        float ax = 0.0f, ay = 0.0f, bx = 0.0f, by = 0.0f;
        if (lane >= d) {
          ax = TD_R(px)[e];
          ay = TD_R(py)[e];
          if (HALO) {
            bx = TD_R(qx)[e];
            by = TD_R(qy)[e];
          }
        } else if (HALO) {
          ax = TD_R(qx)[e];
          ay = TD_R(qy)[e];
        }
        if (c0 + lane * kE + e < s) ax = ay = 0.0f;
        TD_R(x)[e] = TD_R(x)[e] + ax;
        TD_R(y)[e] = flush(TD_R(y)[e] + ay);
        if (HALO) {
          if (c0 - kSpan + lane * kE + e < s) bx = by = 0.0f;
          TD_R(hx)[e] = TD_R(hx)[e] + bx;
          TD_R(hy)[e] = flush(TD_R(hy)[e] + by);
        }
      }
    }
  }
}

// whether every thread of the group holds flag (uniform); WIDE through
// wu[0, 32)
template <bool WIDE>
__device__ __forceinline__ bool group_all(TD_VPARAM(int, flag),
                                          uint32_t* wu, int g, int g0) {
  TD_VAR(unsigned, m);
  TD_BALLOT(TD_R(m), TD_R(flag));
  if (!WIDE) return TD_U(m) == 0xffffffffu;
  TD_SIMT {
    if (TD_LANE == 0) wu[(TD_TID - g0) >> 5] = TD_R(m) == 0xffffffffu;
  }
  TD_SYNC();
  bool all = true;
  for (int w = 0; w < g; ++w) all = all && wu[w];
  TD_SYNC();
  return all;
}

// "the last run end so far": its cumulative weight and mean * weight
struct Carry {
  int has;
  float w, mw;
};

// one row's shared memory: the candidates' means and weights [n] (then
// the sort's payload, then the run means and weights); for a WIDE group
// the exchange area [256 g] keys (also the scan buffers and the buckets)
// and the warps' carries [32]; one float for the row's total
struct RowSmem {
  float* cm;
  float* cw;
  uint64_t* sh;
  Carry* wc;
  uint64_t* wk;   // WIDE: each warp's last key [32]
  uint32_t* wu;   // WIDE: per-warp flags, maxima and counts [160]
  uint64_t* tk;   // one warp: the sorted tail's keys [kTail]
  uint32_t* rk;   // the rank path (over tk): the tail's keys [kRankMax]
  unsigned char* rp;  // then each position's source [256]
  float* scal;
  int nt;         // the group's threads
  // where slot i lives in cm, cw and the exchange area: transposed, so
  // the group's threads reading their kE keys each touch kE rows of
  // consecutive words (the blocked order, read in place, would put every
  // lane of a warp on the same few banks)
  __device__ __forceinline__ int at(int i) const {
    return (i & (kE - 1)) * nt + (i >> 3);
  }
};

// the sorted tail's rank r in tk (4 keys a lane, transposed likewise)
__device__ __forceinline__ int tail_at(int r) {
  return (r & (kTail / 32 - 1)) * 32 + r / (kTail / 32);
}

__host__ __device__ __forceinline__ size_t row_smem_bytes(int n, bool wide,
                                                          int g) {
  (void)n;  // cm and cw hold the group's 256 g sort lanes
  size_t b = 2 * align16(4ull * kSpan * g) + 16;
  b += 8 * kTail;
  if (wide)
    b += align16(8ull * kSpan * g) + align16(sizeof(Carry) * 32) + 8 * 32 +
         4 * 160;
  return b;
}

__device__ __forceinline__ RowSmem carve_row(unsigned char* base, int n,
                                             bool wide, int g) {
  (void)n;
  RowSmem r;
  r.nt = 32 * g;
  r.cm = reinterpret_cast<float*>(base);
  base += align16(4ull * kSpan * g);
  r.cw = reinterpret_cast<float*>(base);
  base += align16(4ull * kSpan * g);
  r.scal = reinterpret_cast<float*>(base);
  base += 16;
  r.sh = nullptr;
  r.wc = nullptr;
  r.wk = nullptr;
  r.wu = nullptr;
  r.tk = reinterpret_cast<uint64_t*>(base);
  r.rk = reinterpret_cast<uint32_t*>(base);
  r.rp = base + 4 * kRankMax;
  base += 8 * kTail;
  if (wide) {
    r.sh = reinterpret_cast<uint64_t*>(base);
    base += align16(8ull * kSpan * g);
    r.wc = reinterpret_cast<Carry*>(base);
    base += align16(sizeof(Carry) * 32);
    r.wk = reinterpret_cast<uint64_t*>(base);
    r.wu = reinterpret_cast<uint32_t*>(base + 8 * 32);
  }
  return r;
}

// the positions of tn <= kRankMax 32-bit keys tk[0, tn) in their
// stable sort: each key's count of the keys below it and of the equal
// ones before it, taken by the group's first warp over broadcast reads of
// tk, 4 keys a read (the warp pads tk[tn, 32 nb) with ~0u first, which no
// key counts; nb = ceil(tn / 32)). Lane l takes keys l + 32 e, e < nb:
// k holds them, rk their positions. For key j of lane l, the keys of a
// block of 32 before j's count where <= k, those of a block after it
// where < k, those of its own block where < k or equal and at a lane
// below l: no index is compared but there
constexpr int kRankB = kRankMax / 32;
__device__ __forceinline__ void warp_rank(uint32_t* tk, int tn, int g0,
                                          TD_APARAM(uint32_t, k, kRankB),
                                          TD_APARAM(int, rk, kRankB)) {
  const int nb = (tn + 31) >> 5;
  TD_SIMT {
    if (TD_TID - g0 < 32) {
#pragma unroll
      for (int e = 0; e < kRankB; ++e) {
        const int j = TD_LANE + 32 * e;
        if (e < nb && j >= tn) tk[j] = ~0u;
      }
    }
  }
  TD_SYNCWARP();
  TD_SIMT {
    if (TD_TID - g0 < 32) {
      const int lane = TD_LANE;
#pragma unroll
      for (int e = 0; e < kRankB; ++e) {
        if (e >= nb) break;
        const uint32_t key = tk[lane + 32 * e];
        int cnt = 0;
        for (int jb = 0; jb < nb; ++jb) {
          const uint32_t* blk = tk + 32 * jb;
          if (jb < e) {
#pragma unroll
            for (int q = 0; q < 32; q += 4) {
              uint32_t kp[4];
              lds_words<4>(blk + q, kp);
#pragma unroll
              for (int t = 0; t < 4; ++t) cnt += kp[t] <= key;
            }
          } else if (jb > e) {
#pragma unroll
            for (int q = 0; q < 32; q += 4) {
              uint32_t kp[4];
              lds_words<4>(blk + q, kp);
#pragma unroll
              for (int t = 0; t < 4; ++t) cnt += kp[t] < key;
            }
          } else {
#pragma unroll
            for (int q = 0; q < 32; q += 4) {
              uint32_t kp[4];
              lds_words<4>(blk + q, kp);
#pragma unroll
              for (int t = 0; t < 4; ++t)
                cnt += kp[t] < key || (kp[t] == key && q + t < lane);
            }
          }
        }
        TD_R(k)[e] = key;
        TD_R(rk)[e] = cnt;
      }
    }
  }
}

// the rank path's placement (row_compress, one warp): [0, c) sorted, the
// tail [c, n) of tn <= kRankMax slots; each of the 256 positions'
// source into s.rp, a tail index or 0xff (the row's next slot)
__device__ __forceinline__ void rank_place(const RowSmem& s, int n, int c,
                                           int g0) {
  const int tn = n - c;
  TD_SIMT {
#pragma unroll
    for (int e = 0; e < kRankB; ++e) {
      const int j = TD_LANE + 32 * e;
      if (j < tn) s.rk[j] = order_key(s.cm[s.at(c + j)]);
    }
  }
  TD_ARR(uint32_t, tkey, kRankB);
  TD_ARR(int, pos, kRankB);
  warp_rank(s.rk, tn, g0, tkey, pos);
  // each position's source: a tail index, or 0xff (the row's next)
  TD_SIMT {
    uint32_t* sw = reinterpret_cast<uint32_t*>(s.rp);
    sw[TD_LANE] = ~0u;
    sw[TD_LANE + 32] = ~0u;
#pragma unroll
    for (int e = 0; e < kRankB; ++e) {
      if (TD_LANE + 32 * e < tn) {
        int lo = 0, hi = c;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (order_key(s.cm[s.at(mid)]) <= TD_R(tkey)[e]) lo = mid + 1;
          else hi = mid;
        }
        TD_R(pos)[e] += lo;
      }
    }
  }
  TD_SYNCWARP();
  TD_SIMT {
#pragma unroll
    for (int e = 0; e < kRankB; ++e) {
      const int j = TD_LANE + 32 * e;
      if (j < tn) s.rp[TD_R(pos)[e]] = (unsigned char)j;
    }
  }
  TD_SYNCWARP();
}

// which ordering a row took (row_compress's result; K3 tallies them)
constexpr int kPathRuns = 0;  // sorted runs: the network from their merges
constexpr int kPathRank = 1;  // a sorted row and a tail placed by rank
constexpr int kPathTail = 2;  // a sorted row and a wider tail sorted alone
constexpr int kPathNet = 3;   // the whole network

// the compression of one row of n candidates (raw means in s.cm, raw
// weights in s.cw) into c slots at out_m / out_w, by a group of g warps
// whose first thread is g0 (the group has synchronised after writing the
// candidates; tbl is the k1 table, in shared memory); the path its first
// sort took (kPath*). RANK: a sorted row's tail of up to kRankMax
// slots is placed by rank (K3); else it is sorted (K2a and K2b: the rank
// path's code alone, never run, cost them 3-6% at their shapes)
template <bool WIDE, bool RANK = false>
__device__ __forceinline__ int row_compress(const RowSmem& s, int n, int c,
                                             const float* tbl, int tlen,
                                             int g, int g0, float* out_m,
                                             float* out_w) {
  const float inf = f_inf();
  TD_ARR(uint64_t, key, kE);
  TD_ARR(float, sw, kE);
  TD_ARR(float, x, kE);
  TD_ARR(float, y, kE);
  TD_ARR(float, hx, kE);
  TD_ARR(float, hy, kE);
  TD_ARR(int, bk, kE);
  TD_VAR(int, nb);
  TD_VAR(Carry, cr);
  TD_VAR(Carry, co);
  // 1. flushed weights; zero-weight slots keyed +inf (in place)
  TD_SIMT {
    const int gt = TD_TID - g0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = gt * kE + e;
      uint64_t kv = ~0ull;
      if (i < n) {
        const float w = flush(s.cw[s.at(i)]);
        const float m = w > 0.0f ? flush(s.cm[s.at(i)]) : inf;
        s.cm[s.at(i)] = m;
        s.cw[s.at(i)] = w;
        kv = ((uint64_t)order_key(m) << 32) | (uint32_t)i;
      }
      TD_R(key)[e] = kv;
    }
    if (WIDE && TD_LANE == 31) s.wk[gt >> 5] = TD_R(key)[kE - 1];
  }
  group_sync<WIDE>();
  // the candidates are, as a rule, sorted runs: digest rows of c slots
  // side by side (c a power of two), or [0, c) and [c, n). Then the
  // network starts where such runs stand (the odd ones placed reversed):
  // at the merges of 2c keys, or the last merge alone. A one-warp row
  // whose digest row [0, c) is sorted beside an unsorted tail: with RANK
  // and at most kRankMax samples (the staged fold's) the rank path,
  // where no key is sorted and each candidate's position in the stable
  // sort is computed on 32-bit order keys, ties the row's first, then in
  // slot order:
  //   tail slot c + j at #{row i : k_i <= k_j} + #{tail j' : k_j' < k_j,
  //     or k_j' == k_j and j' < j} (an upper-bound search of the row's
  //     keys, warp_rank),
  //   the row's slots at the positions left, in order (row slot i at
  //     i + #{tail j : k_j < k_i}, read off a byte a position);
  // else, at most kTail samples, the tail sorted alone, 4 keys a lane,
  // and placed reversed for the last merge. Else the network runs whole
  const int p = kSpan * g;
  const bool pow2 = (c & (c - 1)) == 0 && 2 * c <= p;
  int path = kPathNet;
  TD_VAR(uint64_t, pk);
  TD_VAR(int, good);
  TD_VAR(int, head);
  TD_SHFL(uint64_t, TD_R(pk), TD_R(key)[kE - 1], TD_LANE - 1);
  TD_SIMT {
    const int gt = TD_TID - g0;
    int gd = 1, hd = 1;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = gt * kE + e;
      if (i > 0 && i < n && (pow2 ? (i & (c - 1)) != 0 : i != c)) {
        const uint64_t prev =
            e > 0 ? TD_R(key)[e - 1]
                  : (TD_LANE > 0 ? TD_R(pk) : (WIDE ? s.wk[(gt >> 5) - 1]
                                                     : 0ull));
        if (TD_R(key)[e] < prev) {
          gd = 0;
          if (i < c) hd = 0;
        }
      }
    }
    TD_R(good) = gd;
    TD_R(head) = hd;
  }
  if (group_all<WIDE>(good, s.wu, g, g0)) {
    path = kPathRuns;
    TD_SIMT {
      const int gt = TD_TID - g0;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = gt * kE + e;
        int slot = i;
        if (pow2) {
          const int x = i & (c - 1);
          if ((i / c) & 1) slot = i - x + (c - 1 - x);
        } else if (i >= c) {
          slot = c + (p - 1 - i);
        }
        TD_R(key)[e] =
            slot < n ? ((uint64_t)order_key(s.cm[s.at(slot)]) << 32) |
                           (uint32_t)slot
                     : ~0ull;
      }
    }
    group_sort<uint64_t, WIDE>(key, g, g0, s.sh, pow2 ? 2 * c : p);
  } else if (RANK && !WIDE && n - c <= kRankMax &&
             group_all<WIDE>(head, s.wu, g, g0)) {
    path = kPathRank;
    rank_place(s, n, c, g0);
    const unsigned char* src = s.rp;
    // the tail keys at this lane's kE positions, and before them (a scan)
    TD_VAR(int, own);
    TD_VAR(int, inc);
    TD_VAR(int, prv);
    TD_SIMT {
      uint32_t b[2];
      lds_words<2>(src + TD_LANE * kE, b);
      const int o = (int)(((b[0] & 0xffu) != 0xffu) +
                          (((b[0] >> 8) & 0xffu) != 0xffu) +
                          (((b[0] >> 16) & 0xffu) != 0xffu) +
                          ((b[0] >> 24) != 0xffu) +
                          ((b[1] & 0xffu) != 0xffu) +
                          (((b[1] >> 8) & 0xffu) != 0xffu) +
                          (((b[1] >> 16) & 0xffu) != 0xffu) +
                          ((b[1] >> 24) != 0xffu));
      TD_R(own) = o;
      TD_R(inc) = o;
    }
    for (int d = 1; d < 32; d <<= 1) {
      TD_SHFL(int, TD_R(prv), TD_R(inc), TD_LANE - d);
      TD_SIMT {
        if (TD_LANE >= d) TD_R(inc) += TD_R(prv);
      }
    }
    TD_SIMT {
      uint32_t b[2];
      lds_words<2>(src + TD_LANE * kE, b);
      int r = TD_R(inc) - TD_R(own);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const uint32_t x = (b[e >> 2] >> (8 * (e & 3))) & 0xffu;
        const int at = TD_LANE * kE + e;
        // the only part of the key step 2 reads: the position's slot
        TD_R(key)[e] = x != 0xffu ? (uint64_t)(c + (int)x)
                                  : (uint64_t)(at - r);
        r += x != 0xffu;
      }
    }
  } else if (!WIDE && n - c <= kTail && group_all<WIDE>(head, s.wu, g, g0)) {
    // a tail past kRankMax: sorted alone, 4 keys a lane, placed
    // reversed for the last merge
    path = kPathTail;
    TD_ARR(uint64_t, tail, kTail / 32);
    TD_SIMT {
#pragma unroll
      for (int e = 0; e < kTail / 32; ++e) {
        const int slot = c + TD_LANE * (kTail / 32) + e;
        TD_R(tail)[e] =
            slot < n
                ? ((uint64_t)order_key(s.cm[s.at(slot)]) << 32) |
                      (uint32_t)slot
                : ~0ull;
      }
    }
    group_sort<uint64_t, false, kTail / 32>(tail, 1, g0, nullptr);
    TD_SIMT {
#pragma unroll
      for (int e = 0; e < kTail / 32; ++e)
        s.tk[tail_at(TD_LANE * (kTail / 32) + e)] = TD_R(tail)[e];
    }
    TD_SYNCWARP();
    TD_SIMT {
      const int gt = TD_TID - g0;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = gt * kE + e;
        if (i >= c) {
          const int r = (p - 1 - i);  // the tail's rank, reversed
          TD_R(key)[e] = r < kTail ? s.tk[tail_at(r)] : ~0ull;
        }
      }
    }
    group_sort<uint64_t, WIDE>(key, g, g0, s.sh, p);
  } else {
    group_sort<uint64_t, WIDE>(key, g, g0, s.sh);
  }
  // 2. the weight scan and the flushed scan of mean * weight
  TD_SIMT {
    const int gt = TD_TID - g0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      float m = inf, w = 0.0f;
      if (gt * kE + e < n) {
        const uint32_t src = (uint32_t)TD_R(key)[e];
        m = s.cm[s.at(src)];
        w = s.cw[s.at(src)];
      }
      TD_R(sw)[e] = w;
      TD_R(x)[e] = w;
      TD_R(y)[e] = w > 0.0f ? flush(m * w) : 0.0f;
    }
  }
  float* shx = reinterpret_cast<float*>(s.sh);
  float* shy = WIDE ? shx + kSpan * g : nullptr;
  if (WIDE) {
    TD_SIMT {
      const int gt = TD_TID - g0;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        shx[s.at(gt * kE + e)] = TD_R(x)[e];
        shy[s.at(gt * kE + e)] = TD_R(y)[e];
      }
    }
    TD_SYNC();
    TD_SIMT {
      const int h0 = (((TD_TID - g0) >> 5) - 1) * kSpan + TD_LANE * kE;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        TD_R(hx)[e] = h0 + e >= 0 ? shx[s.at(h0 + e)] : 0.0f;
        TD_R(hy)[e] = h0 + e >= 0 ? shy[s.at(h0 + e)] : 0.0f;
      }
    }
    TD_SYNC();
  }
  warp_scan2<WIDE>(x, y, hx, hy, n, g0);
  if (WIDE) {
    for (int st = kSpan; st < n; st <<= 1) {
      TD_SIMT {
        const int gt = TD_TID - g0;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          shx[s.at(gt * kE + e)] = TD_R(x)[e];
          shy[s.at(gt * kE + e)] = TD_R(y)[e];
        }
      }
      TD_SYNC();
      TD_SIMT {
        const int gt = TD_TID - g0;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int src = gt * kE + e - st;
          const float ax = src >= 0 ? shx[s.at(src)] : 0.0f;
          const float ay = src >= 0 ? shy[s.at(src)] : 0.0f;
          TD_R(x)[e] = TD_R(x)[e] + ax;
          TD_R(y)[e] = flush(TD_R(y)[e] + ay);
        }
      }
      TD_SYNC();
    }
  }
  // 3 and 4. left-edge quantile and bucket, from the row's total
  TD_SIMT {
    const int gt = TD_TID - g0;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (gt * kE + e == n - 1) s.scal[0] = TD_R(x)[e];
  }
  group_sync<WIDE>();
  const float total = clamp_tiny(s.scal[0]);
  TD_SIMT {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float q = flush(flush(TD_R(x)[e] - TD_R(sw)[e]) / total);
      const int b = upper_bound(tbl, tlen, q);
      TD_R(bk)[e] = b < c - 1 ? b : c - 1;
    }
  }
  // the next thread's first bucket
  if (WIDE) {
    int* shb = reinterpret_cast<int*>(s.sh);
    TD_SIMT {
      const int gt = TD_TID - g0;
#pragma unroll
      for (int e = 0; e < kE; ++e) shb[s.at(gt * kE + e)] = TD_R(bk)[e];
    }
    TD_SYNC();
    TD_SIMT {
      const int nx = (TD_TID - g0 + 1) * kE;
      TD_R(nb) = nx < n ? shb[s.at(nx)] : -1;
    }
  } else {
    TD_SHFL(int, TD_R(nb), TD_R(bk)[0], TD_LANE + 1);
  }
  // 5. run ends; the last end before each key (a warp scan of the last
  // end so far, then the warps before, then the thread's own keys)
  TD_SIMT {
    const int gt = TD_TID - g0;
    Carry a{0, 0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = gt * kE + e;
      const int nxt = e + 1 < kE ? TD_R(bk)[e + 1] : TD_R(nb);
      if (i < n && (i == n - 1 || TD_R(bk)[e] != nxt)) {
        a.has = 1;
        a.w = TD_R(x)[e];
        a.mw = TD_R(y)[e];
      }
    }
    TD_R(cr) = a;
  }
  for (int d = 1; d < 32; d <<= 1) {
    TD_SHFL(int, TD_R(co).has, TD_R(cr).has, TD_LANE - d);
    TD_SHFL(float, TD_R(co).w, TD_R(cr).w, TD_LANE - d);
    TD_SHFL(float, TD_R(co).mw, TD_R(cr).mw, TD_LANE - d);
    TD_SIMT {
      if (TD_LANE >= d && !TD_R(cr).has && TD_R(co).has) TD_R(cr) = TD_R(co);
    }
  }
  if (WIDE) {
    TD_SIMT {
      if (TD_LANE == 31) s.wc[(TD_TID - g0) >> 5] = TD_R(cr);
    }
  }
  TD_SHFL(int, TD_R(co).has, TD_R(cr).has, TD_LANE - 1);
  TD_SHFL(float, TD_R(co).w, TD_R(cr).w, TD_LANE - 1);
  TD_SHFL(float, TD_R(co).mw, TD_R(cr).mw, TD_LANE - 1);
  group_sync<WIDE>();  // the carries; every gather of step 2 done
  TD_SIMT {
    const int gt = TD_TID - g0;
    Carry run{0, 0.0f, 0.0f};
    if (TD_LANE > 0 && TD_R(co).has) {
      run = TD_R(co);
    } else if (WIDE) {
      for (int w = (gt >> 5) - 1; w >= 0; --w) {
        if (s.wc[w].has) {
          run = s.wc[w];
          break;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = gt * kE + e;
      uint64_t kv = ~0ull;
      if (i < n) {
        float nm = inf, nw = 0.0f;
        const int nxt = e + 1 < kE ? TD_R(bk)[e + 1] : TD_R(nb);
        if (i == n - 1 || TD_R(bk)[e] != nxt) {
          const float wb = run.has ? run.w : 0.0f;
          const float mwb = run.has ? run.mw : 0.0f;
          const float seg_w = flush(TD_R(x)[e] - wb);
          const float seg_mw = flush(TD_R(y)[e] - mwb);
          if (seg_w > 0.0f) {
            nm = flush(seg_mw / clamp_tiny(seg_w));
            nw = seg_w;
          }
          run = Carry{1, TD_R(x)[e], TD_R(y)[e]};
        }
        s.cm[s.at(i)] = nm;
        s.cw[s.at(i)] = nw;
        kv = ((uint64_t)order_key(nm) << 32) | (uint32_t)i;
      }
      TD_R(key)[e] = kv;
    }
  }
  group_sync<WIDE>();
  // 6. sort by mean, keep the first c: the finite run means (class 0)
  // first, then the +inf ones (class 1), then NaN (class 2), each class
  // in slot order but the first, which the keys order. As a rule the
  // finite means are nondecreasing in slot order, and counts place every
  // key; else, where at most kTail are finite, those alone are sorted (4
  // keys a lane) and counts place the rest; else the bitonic sort
  constexpr uint32_t kOkInf = 0xff800000u;  // order_key(+inf)
  TD_VAR(uint32_t, fmn);
  TD_VAR(uint32_t, sc);
  TD_VAR(uint32_t, tmp);
  TD_VAR(uint32_t, cnt);
  TD_VAR(uint32_t, tot);
  TD_SIMT {
    uint32_t last = 0, first = 0xffffffffu, k3 = 0;
    int gd = 1;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (TD_R(key)[e] == ~0ull) continue;
      const uint32_t ok = (uint32_t)(TD_R(key)[e] >> 32);
      if (ok < kOkInf) {
        if (ok < last) gd = 0;
        if (first == 0xffffffffu) first = ok;
        last = ok > last ? ok : last;
      }
      k3 += ok < kOkInf ? 1u : (ok == kOkInf ? 1u << 10 : 1u << 20);
    }
    TD_R(fmn) = first;
    TD_R(good) = gd;
    TD_R(sc) = last;
    TD_R(cnt) = k3;
  }
  // the greatest finite key before each thread
  for (int d = 1; d < 32; d <<= 1) {
    TD_SHFL(uint32_t, TD_R(tmp), TD_R(sc), TD_LANE - d);
    TD_SIMT {
      if (TD_LANE >= d && TD_R(tmp) > TD_R(sc)) TD_R(sc) = TD_R(tmp);
    }
  }
  TD_SHFL(uint32_t, TD_R(tmp), TD_R(sc), TD_LANE - 1);
  if (WIDE) {
    TD_SIMT {
      if (TD_LANE == 31) s.wu[32 + ((TD_TID - g0) >> 5)] = TD_R(sc);
    }
    TD_SYNC();
  }
  TD_SIMT {
    uint32_t before = TD_LANE > 0 ? TD_R(tmp) : 0u;
    if (WIDE)
      for (int w = 0; w < ((TD_TID - g0) >> 5); ++w)
        before = s.wu[32 + w] > before ? s.wu[32 + w] : before;
    if (TD_R(fmn) != 0xffffffffu && TD_R(fmn) < before) TD_R(good) = 0;
    TD_R(sc) = TD_R(cnt);
  }
  // the classes' counts before each thread (packed 10 bits apiece) and
  // the group's totals
  for (int d = 1; d < 32; d <<= 1) {
    TD_SHFL(uint32_t, TD_R(tmp), TD_R(sc), TD_LANE - d);
    TD_SIMT {
      if (TD_LANE >= d) TD_R(sc) += TD_R(tmp);
    }
  }
  TD_SHFL(uint32_t, TD_R(tmp), TD_R(sc), TD_LANE - 1);  // exclusive
  TD_SHFL(uint32_t, TD_R(tot), TD_R(sc), 31);            // the warp's
  if (WIDE) {
    TD_SIMT {
      if (TD_LANE == 0) s.wu[64 + ((TD_TID - g0) >> 5)] = TD_R(tot);
    }
    TD_SYNC();
  }
  // (r0, r1, r2): this thread's first rank in each class; t0, t1 totals
  TD_VAR(int, r0);
  TD_VAR(int, r1);
  TD_VAR(int, r2);
  int t0, t1;
  {
    const uint32_t wt = WIDE ? 0u : TD_U(tot);
    t0 = (int)(wt & 1023u);
    t1 = (int)((wt >> 10) & 1023u);
    if (WIDE) {
      t0 = t1 = 0;
      for (int w = 0; w < g; ++w) {
        t0 += (int)(s.wu[64 + w] & 1023u);
        t1 += (int)((s.wu[64 + w] >> 10) & 1023u);
      }
    }
  }
  TD_SIMT {
    const int gt = TD_TID - g0;
    const uint32_t ex = TD_LANE > 0 ? TD_R(tmp) : 0u;
    int a = (int)(ex & 1023u), b = (int)((ex >> 10) & 1023u),
        q = (int)(ex >> 20);
    if (WIDE) {
      for (int w = 0; w < (gt >> 5); ++w) {
        const uint32_t v = s.wu[64 + w];
        a += (int)(v & 1023u);
        b += (int)((v >> 10) & 1023u);
        q += (int)(v >> 20);
      }
    }
    TD_R(r0) = a;
    TD_R(r1) = b;
    TD_R(r2) = q;
  }
  const bool mono = group_all<WIDE>(good, s.wu, g, g0);
  if (mono || t0 <= kTail) {
    if (!mono) {
      // the finite keys alone, compacted in slot order, sorted by every
      // warp of the group (the first writes them out)
      TD_SIMT {
        int r = TD_R(r0);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const uint64_t kv = TD_R(key)[e];
          if (kv != ~0ull && (uint32_t)(kv >> 32) < kOkInf)
            s.tk[tail_at(r++)] = kv;
        }
      }
      group_sync<WIDE>();
      TD_ARR(uint64_t, fin, kTail / 32);
      TD_SIMT {
#pragma unroll
        for (int e = 0; e < kTail / 32; ++e) {
          const int r = TD_LANE * (kTail / 32) + e;
          TD_R(fin)[e] = r < t0 ? s.tk[tail_at(r)] : ~0ull;
        }
      }
      group_sort<uint64_t, false, kTail / 32>(fin, 1, g0, nullptr);
      TD_SIMT {
        if (TD_TID - g0 < 32) {
#pragma unroll
          for (int e = 0; e < kTail / 32; ++e) {
            const int r = TD_LANE * (kTail / 32) + e;
            if (r < t0 && r < c) {
              const int src = (int)(uint32_t)TD_R(fin)[e];
              out_m[r] = s.cm[s.at(src)];
              out_w[r] = s.cw[s.at(src)];
            }
          }
        }
      }
    }
    TD_SIMT {
      const int gt = TD_TID - g0;
      int a = TD_R(r0), b = TD_R(r1), q = TD_R(r2);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = gt * kE + e;
        if (i >= n) continue;
        const uint32_t ok = (uint32_t)(TD_R(key)[e] >> 32);
        int pos;
        if (ok < kOkInf) {
          pos = a++;
          if (!mono) continue;  // placed by the sort above
        } else {
          pos = ok == kOkInf ? t0 + b++ : t0 + t1 + q++;
        }
        if (pos < c) {
          out_m[pos] = s.cm[s.at(i)];
          out_w[pos] = s.cw[s.at(i)];
        }
      }
    }
  } else {
    group_sort<uint64_t, WIDE>(key, g, g0, s.sh);
    TD_SIMT {
      const int gt = TD_TID - g0;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = gt * kE + e;
        if (i < c) {
          const uint32_t src = (uint32_t)TD_R(key)[e];
          out_m[i] = s.cm[s.at(src)];
          out_w[i] = s.cw[s.at(src)];
        }
      }
    }
  }
  group_sync<WIDE>();
  return path;
}

// ---------------------------------------------------------------------------
// K2a

// M <= 256: a warp a row, rpw consecutive rows a warp, the next row's
// candidates loaded (cp.async) while this one is compressed
// (80 registers: three blocks an SM; measured faster than 99 registers
// and two, or 64 and four)
__global__ void TD_BOUNDS(kWarps * 32, 3)
    td_compress_warps(const float* __restrict__ means,
        const float* __restrict__ weights, long long s, int m, int c,
        const float* tbl, int tlen, float* __restrict__ out_m,
        float* __restrict__ out_w, int rpw) {
  TD_DYNAMIC_SMEM(smem);
  float* tb = reinterpret_cast<float*>(smem);
  TD_GROUP(0, (int)blockDim.x);
  TD_SIMT {
    for (int i = TD_TID; i < tlen; i += (int)blockDim.x) tb[i] = tbl[i];
  }
  TD_SYNC();
  const int nw = (int)blockDim.x / 32;
  const size_t rb = row_smem_bytes(m, false, 1);
  TD_FOR_GROUPS(w, 32) {
    unsigned char* base = smem + align16(4ull * tlen) + (size_t)w * 2 * rb;
    const long long first = ((long long)blockIdx.x * nw + w) * rpw;
    const long long last = first + rpw < s ? first + rpw : s;
    for (long long row = first; row < last; ++row) {
      // row + 1 loads into the other buffer while row is compressed
      for (long long ld = row == first ? row : row + 1;
           ld <= row + 1 && ld < last; ++ld) {
        const RowSmem d = carve_row(base + ((ld - first) & 1) * rb, m,
                                    false, 1);
        TD_SIMT {
          for (int i = TD_LANE; i < m; i += 32) {
            cp_async4(d.cm + d.at(i), means + ld * m + i);
            cp_async4(d.cw + d.at(i), weights + ld * m + i);
          }
          cp_async_commit();
        }
      }
      TD_SIMT {
        if (row + 1 < last) cp_async_wait<1>();
        else cp_async_wait<0>();
      }
      TD_SYNCWARP();
      row_compress<false>(carve_row(base + ((row - first) & 1) * rb, m,
                                    false, 1),
                          m, c, tb, tlen, 1, w * 32, out_m + row * c,
                          out_w + row * c);
    }
  }
}

// 256 < M <= 4,096: a block of M / 256 warps (rounded up to a power of
// two) a row
__global__ void TD_BOUNDS(16 * 32, 1)
    td_compress_wide(const float* __restrict__ means,
        const float* __restrict__ weights, int m, int c, const float* tbl,
        int tlen, float* __restrict__ out_m, float* __restrict__ out_w) {
  TD_DYNAMIC_SMEM(smem);
  const int g = (int)blockDim.x / 32;
  float* tb = reinterpret_cast<float*>(smem);
  const RowSmem r = carve_row(smem + align16(4ull * tlen), m, true, g);
  const long long row = blockIdx.x;
  TD_GROUP(0, (int)blockDim.x);
  TD_SIMT {
    for (int i = TD_TID; i < tlen; i += (int)blockDim.x) tb[i] = tbl[i];
    for (int i = TD_TID; i < m; i += (int)blockDim.x) {
      r.cm[r.at(i)] = means[row * m + i];
      r.cw[r.at(i)] = weights[row * m + i];
    }
  }
  TD_SYNC();
  row_compress<true>(r, m, c, tb, tlen, g, 0, out_m + row * c,
                     out_w + row * c);
}

// rows past what a block holds: one block a row over a global slab, each
// step a block barrier
struct SlabBufs {
  uint64_t* key;          // [p]
  float* sm;              // [n] sorted means, then the run means
  float* sw;              // [n] sorted weights, then the run weights
  float* x0; float* y0;   // [n] scan buffers (w, m*w)
  float* x1; float* y1;   // [n] the candidates on entry, then scan buffers
  int* b;                 // [n] buckets
  int* e0; int* e1;       // [n] the run-end max scan
};

__host__ __device__ __forceinline__ size_t slab_bytes(int n, int p) {
  return align16(8ull * p) + 9 * align16(4ull * n);
}

__device__ __forceinline__ SlabBufs carve_slab(unsigned char* base, int n,
                                               int p) {
  SlabBufs r;
  const size_t f = align16(4ull * n);
  r.key = reinterpret_cast<uint64_t*>(base);
  unsigned char* q = base + align16(8ull * p);
  r.sm = reinterpret_cast<float*>(q); q += f;
  r.sw = reinterpret_cast<float*>(q); q += f;
  r.x0 = reinterpret_cast<float*>(q); q += f;
  r.y0 = reinterpret_cast<float*>(q); q += f;
  r.x1 = reinterpret_cast<float*>(q); q += f;
  r.y1 = reinterpret_cast<float*>(q); q += f;
  r.b = reinterpret_cast<int*>(q); q += f;
  r.e0 = reinterpret_cast<int*>(q); q += f;
  r.e1 = reinterpret_cast<int*>(q);
  return r;
}

__device__ void slab_sort(uint64_t* s, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      TD_SIMT {
        for (int t = TD_TID; t < (p >> 1); t += (int)blockDim.x) {
          const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          const int l = i | j;
          const uint64_t x = s[i], y = s[l];
          if ((x > y) == ((i & k) == 0)) {
            s[i] = y;
            s[l] = x;
          }
        }
      }
      TD_SYNC();
    }
  }
}

__global__ void td_compress_scratch(const float* __restrict__ means,
                                    const float* __restrict__ weights,
                                    int m, int c, const float* tbl, int tlen,
                                    unsigned char* scratch,
                                    float* __restrict__ out_m,
                                    float* __restrict__ out_w) {
  const long long row = blockIdx.x;
  const int n = m, p = pow2_at_least(m), nt = (int)blockDim.x;
  const float inf = f_inf();
  const SlabBufs r = carve_slab(scratch + (size_t)row * slab_bytes(m, p), m,
                                p);
  TD_GROUP(0, nt);
  TD_SIMT {
    for (int i = TD_TID; i < p; i += nt) {
      if (i < n) {
        const float w = flush(weights[row * m + i]);
        const float key = w > 0.0f ? flush(means[row * m + i]) : inf;
        r.x1[i] = key;
        r.y1[i] = w;
        r.key[i] = ((uint64_t)order_key(key) << 32) | (uint32_t)i;
      } else {
        r.key[i] = ~0ull;
      }
    }
  }
  TD_SYNC();
  slab_sort(r.key, p);
  TD_SIMT {
    for (int i = TD_TID; i < n; i += nt) {
      const uint32_t src = (uint32_t)r.key[i];
      r.sm[i] = r.x1[src];
      r.sw[i] = r.y1[src];
      r.x0[i] = r.sw[i];
      r.y0[i] = r.sw[i] > 0.0f ? flush(r.sm[i] * r.sw[i]) : 0.0f;
    }
  }
  TD_SYNC();
  float *xa = r.x0, *ya = r.y0, *xb = r.x1, *yb = r.y1;
  for (int s = 1; s < n; s <<= 1) {
    TD_SIMT {
      for (int i = TD_TID; i < n; i += nt) {
        const float xs = i >= s ? xa[i - s] : 0.0f;
        const float ys = i >= s ? ya[i - s] : 0.0f;
        xb[i] = xa[i] + xs;
        yb[i] = flush(ya[i] + ys);
      }
    }
    TD_SYNC();
    float* t = xa; xa = xb; xb = t;
    t = ya; ya = yb; yb = t;
  }
  const float* wc = xa;
  const float* mwc = ya;
  const float total = clamp_tiny(wc[n - 1]);
  TD_SIMT {
    for (int i = TD_TID; i < n; i += nt) {
      const float q = flush(flush(wc[i] - r.sw[i]) / total);
      const int b = upper_bound(tbl, tlen, q);
      r.b[i] = b < c - 1 ? b : c - 1;
    }
  }
  TD_SYNC();
  TD_SIMT {
    for (int i = TD_TID; i < n; i += nt)
      r.e0[i] = (i == n - 1 || r.b[i] != r.b[i + 1]) ? i : -1;
  }
  TD_SYNC();
  int *ea = r.e0, *eb = r.e1;
  for (int s = 1; s < n; s <<= 1) {
    TD_SIMT {
      for (int i = TD_TID; i < n; i += nt) {
        const int v = ea[i], u = i >= s ? ea[i - s] : -1;
        eb[i] = v > u ? v : u;
      }
    }
    TD_SYNC();
    int* t = ea; ea = eb; eb = t;
  }
  TD_SIMT {
    for (int i = TD_TID; i < p; i += nt) {
      if (i < n) {
        float nm = inf, nw = 0.0f;
        if (i == n - 1 || r.b[i] != r.b[i + 1]) {
          const int j = i > 0 ? ea[i - 1] : -1;
          const float seg_w = flush(wc[i] - (j >= 0 ? wc[j] : 0.0f));
          const float seg_mw = flush(mwc[i] - (j >= 0 ? mwc[j] : 0.0f));
          if (seg_w > 0.0f) {
            nm = flush(seg_mw / clamp_tiny(seg_w));
            nw = seg_w;
          }
        }
        r.sm[i] = nm;
        r.sw[i] = nw;
        r.key[i] = ((uint64_t)order_key(nm) << 32) | (uint32_t)i;
      } else {
        r.key[i] = ~0ull;
      }
    }
  }
  TD_SYNC();
  slab_sort(r.key, p);
  TD_SIMT {
    for (int i = TD_TID; i < c; i += nt) {
      const uint32_t src = (uint32_t)r.key[i];
      out_m[row * c + i] = r.sm[src];
      out_w[row * c + i] = r.sw[src];
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: the sort

struct Batch {
  const void* rows;  // int32 or int64 [n]
  int rows64;
  const float* values;
  const float* weights;
  int n;
  int k;
};

struct Sorted {  // ops/tdigest._sort_batch's four outputs
  long long* srows;
  float* svals;
  float* sw;
  float* raw;
};

__device__ __forceinline__ K96 batch_key(const Batch& b, long long q) {
  const float w = flush(b.weights[q]);
  const bool live = w > 0.0f;
  long long row = b.k;
  if (live)
    row = b.rows64 ? static_cast<const long long*>(b.rows)[q]
                   : (long long)static_cast<const int*>(b.rows)[q];
  const float raw = live ? b.values[q] : 1.0f;
  K96 key;
  key.hi = ((uint64_t)row << 32) | order_key(flush(raw));
  key.lo = (uint32_t)q;
  return key;
}

__device__ __forceinline__ void emit_sorted(const Batch& b, const Sorted& o,
                                            long long pos, const K96& key) {
  const long long q = key.lo;
  const float w = flush(b.weights[q]);
  const float raw = w > 0.0f ? b.values[q] : 1.0f;
  o.srows[pos] = (long long)(key.hi >> 32);
  o.svals[pos] = flush(raw);
  o.sw[pos] = w;
  o.raw[pos] = raw;
}

// the merge path's split at diagonal d of runs a [na] and b [nb]: how many
// of the first d outputs come from a (a first on ties: a holds the
// earlier samples, so this is the 96-bit key's order)
__device__ __forceinline__ int merge_split(const uint64_t* a, int na,
                                           const uint64_t* b, int nb, int d) {
  int lo = d - nb > 0 ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// merge_split by a warp in global memory: 32 probes a round, so log32 of
// the run's length dependent loads (uniform result)
__device__ __forceinline__ int warp_merge_split(const uint64_t* a, int na,
                                                const uint64_t* b, int nb,
                                                int d) {
  int lo = d - nb > 0 ? d - nb : 0, hi = d < na ? d : na;
  TD_VAR(unsigned, m);
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    TD_BALLOT(TD_R(m), lo + TD_LANE * step < hi &&
                           a[lo + TD_LANE * step] <=
                               b[d - 1 - (lo + TD_LANE * step)]);
    const int cnt = td_popc(TD_U(m));
    if (cnt == 0) {
      hi = lo;
    } else {
      const int p = lo + (cnt - 1) * step;
      lo = p + 1;
      hi = p + step < hi ? p + step : hi;
    }
  }
  return lo;
}

// kE merged outputs from position t of a window of tile keys whose runs
// of len pair up from 0 (in shared memory)
__device__ __forceinline__ void merge_in_window(const uint64_t* sh,
                                                const uint32_t* sl, int tile,
                                                int len, int t, uint64_t* dh,
                                                uint32_t* dl) {
  if (t >= tile) return;
  const int base = t / (2 * len) * (2 * len);
  const int pna = len < tile - base ? len : tile - base;
  const int pb = base + pna;
  const int rest = tile - pb;
  const int pnb = rest < 0 ? 0 : (rest < len ? rest : len);
  const int d = t - base;
  int ia = merge_split(sh + base, pna, sh + pb, pnb, d), ib = d - ia;
  for (int e = 0; e < kE && t + e < tile; ++e) {
    int src;
    if (ib >= pnb || (ia < pna && sh[base + ia] <= sh[pb + ib]))
      src = base + ia++;
    else
      src = pb + ib++;
    dh[t + e] = sh[src];
    dl[t + e] = sl[src];
  }
}

// tiles of kSortTile samples: each warp sorts 256 in registers by the
// 96-bit key, then three merge levels in shared memory; the last sort
// launch (fin) writes the sorted batch, else the keys
__global__ void TD_BOUNDS(kWarps * 32, 1) td_sort_tile(Batch b, uint64_t* ohi,
                                                   uint32_t* olo, Sorted o,
                                                   int fin) {
  TD_DYNAMIC_SMEM(smem);
  // two buffers of keys, h(b) and l(b), at computed addresses
  uint64_t* const hb = reinterpret_cast<uint64_t*>(smem);
  uint32_t* const lb = reinterpret_cast<uint32_t*>(smem + 16 * kSortTile);
#define H(b) (hb + (b) * kSortTile)
#define L(b) (lb + (b) * kSortTile)
  const long long t0 = (long long)blockIdx.x * kSortTile;
  const int tile = (int)(b.n - t0 < kSortTile ? b.n - t0 : kSortTile);
  TD_GROUP(0, (int)blockDim.x);
  TD_FOR_GROUPS(w, 32) {
    TD_ARR(K96, key, kE);
    TD_SIMT {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const long long q = t0 + w * kSpan + TD_LANE * kE + e;
        K96 kv;
        kv.hi = ~0ull;
        kv.lo = ~0u;
        if (q < b.n) kv = batch_key(b, q);
        TD_R(key)[e] = kv;
      }
    }
    group_sort<K96, false>(key, 1, w * 32, nullptr);
    TD_SIMT {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = w * kSpan + TD_LANE * kE + e;
        if (i < tile) {
          H(0)[i] = TD_R(key)[e].hi;
          L(0)[i] = TD_R(key)[e].lo;
        }
      }
    }
  }
  TD_GROUP(0, (int)blockDim.x);
  TD_SYNC();
  int cur = 0;
  for (int len = kSpan; len < tile; len <<= 1, cur ^= 1) {
    TD_SIMT {
      merge_in_window(H(cur), L(cur), tile, len, TD_TID * kE, H(cur ^ 1),
                      L(cur ^ 1));
    }
    TD_SYNC();
  }
  TD_SIMT {
    for (int i = TD_TID; i < tile; i += (int)blockDim.x) {
      if (fin) {
        K96 kv;
        kv.hi = H(cur)[i];
        kv.lo = L(cur)[i];
        emit_sorted(b, o, t0 + i, kv);
      } else {
        ohi[t0 + i] = H(cur)[i];
        olo[t0 + i] = L(cur)[i];
      }
    }
  }
#undef H
#undef L
}

// one merge-path pass: pairs of sorted runs of len >= kSortTile samples
// into runs of 2 len; a block writes kMergeOut outputs (kE a thread)
// from the inputs they come from (two warps find them), staged in shared
// memory
__global__ void TD_BOUNDS(kMergeOut / kE, 1) td_sort_merge(
    Batch b, const uint64_t* ihi, const uint32_t* ilo, uint64_t* ohi,
    uint32_t* olo, long long len, Sorted o, int fin) {
  TD_DYNAMIC_SMEM(smem);
  uint64_t* shi = reinterpret_cast<uint64_t*>(smem);
  uint32_t* slo = reinterpret_cast<uint32_t*>(smem + 8 * kMergeOut);
  int* win = reinterpret_cast<int*>(smem + 12 * kMergeOut);
  const long long n = b.n;
  const long long o0 = (long long)blockIdx.x * kMergeOut;
  const int tile = (int)(n - o0 < kMergeOut ? n - o0 : kMergeOut);
  const long long a0 = o0 / (2 * len) * (2 * len), b0 = a0 + len;
  const int na = (int)(len < n - a0 ? len : n - a0);
  const long long nbl = n - b0;
  const int nb = (int)(nbl < 0 ? 0 : (nbl < len ? nbl : len));
  const int d0 = (int)(o0 - a0);
  TD_FOR_GROUPS(w, 32) {
    if (w < 2) {
      const int split =
          warp_merge_split(ihi + a0, na, ihi + b0, nb, d0 + (w ? tile : 0));
      TD_SIMT {
        if (TD_LANE == 0) win[w] = split;
      }
    }
  }
  TD_GROUP(0, (int)blockDim.x);
  TD_SYNC();
  const int ia0 = win[0], ra = win[1] - win[0];
  TD_SIMT {
    for (int i = TD_TID; i < tile; i += (int)blockDim.x) {
      const long long src =
          i < ra ? a0 + ia0 + i : b0 + (d0 - ia0) + (i - ra);
      shi[i] = ihi[src];
      slo[i] = ilo[src];
    }
  }
  TD_SYNC();
  TD_SIMT {
    const int t = TD_TID * kE;
    if (t < tile) {
      int ia = merge_split(shi, ra, shi + ra, tile - ra, t);
      int ib = t - ia;
      for (int e = 0; e < kE && t + e < tile; ++e) {
        int src;
        if (ib >= tile - ra || (ia < ra && shi[ia] <= shi[ra + ib]))
          src = ia++;
        else
          src = ra + ib++;
        const long long q = o0 + t + e;
        if (fin) {
          K96 kv;
          kv.hi = shi[src];
          kv.lo = slo[src];
          emit_sorted(b, o, q, kv);
        } else {
          ohi[q] = shi[src];
          olo[q] = slo[src];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: the scans

struct ScanBufs {
  // the three N-long prefix scans (w, v*w, w/v), before any shift >= T
  float* pw; float* pvw; float* prc;
  // the in-chunk segmented scans, forward and backward (flipped), [g*128]
  float* svf; float* svb;
  // per chunk: the carry (last column, then its shifts below T / 128),
  // its flag, and the chunk's first start lane
  float* cvf; int* cff; int* fsf;
  float* cvb; int* cfb; int* fsb;
};

__host__ __device__ __forceinline__ size_t scan_tile_smem(int t) {
  const int w = 2 * t, nc = w / kChunk;
  return 44ull * w + 10 * align16(4ull * nc);
}

// the window [t0 - T, t0 + T) of a tile of T samples: the N-long scans,
// the in-chunk segmented scans and the chunk carries over their shifts
// below T (T / 128 for the carries), each step from one buffer into the
// other (a barrier a step); every thread holds the window's positions
// j = tid + r * threads
__global__ void TD_BOUNDS(1024, 1)
    td_scan_tile(const long long* __restrict__ srows,
        const float* __restrict__ svals, const float* __restrict__ sw, int n,
        int g, int t, ScanBufs o) {
  TD_DYNAMIC_SMEM(smem);
  const int w = 2 * t, nc = w / kChunk, hc = t / kChunk;
  const int nt = (int)blockDim.x;
  // two buffers (b) of: the N-long scans X(b, 0..2), the segmented
  // values V(b, 0..1) and their flags F(b, 0..1) (bit 0 the scan's, bit 1
  // a real start); the chunks' carries CV(b, d), CF(b, d) and first
  // starts FIRST(d). Addresses, not arrays of pointers (those would live
  // in local memory: the buffer index is not a constant)
  float* const fb = reinterpret_cast<float*>(smem);
  unsigned char* const flb = smem + 40ull * w;
  const size_t ca = align16(4ull * nc) / 4;
  float* const cvb = reinterpret_cast<float*>(flb + 4ull * w);
  int* const cfb = reinterpret_cast<int*>(cvb + 4 * ca);
  int* const fsb = cfb + 4 * ca;
#define X(b, k) (fb + ((b) * 5 + (k)) * (size_t)w)
#define V(b, k) (fb + ((b) * 5 + 3 + (k)) * (size_t)w)
#define F(b, k) (flb + ((b) * 2 + (k)) * (size_t)w)
#define CV(b, d) (cvb + ((b) * 2 + (d)) * ca)
#define CF(b, d) (cfb + ((b) * 2 + (d)) * ca)
#define FIRST(d) (fsb + (d) * ca)
  const long long t0 = (long long)blockIdx.x * t;
  const long long base = t0 - t;  // the window's first position
  TD_GROUP(0, nt);
  TD_SIMT {
    for (int i = TD_TID; i < 2 * nc; i += nt) FIRST(i / nc)[i % nc] = kChunk;
  }
  TD_SYNC();
  TD_SIMT {
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const int j = TD_TID + r * nt;
      if (j >= w) continue;
      const long long q = base + j;
      float pw = 0.0f, pv = 0.0f, pr = 0.0f, vf = 0.0f, vb = 0.0f;
      bool sf = false, sb = false;
      if (q >= 0 && q < n) {
        pw = sw[q];
        const float v = svals[q];
        const float prod = flush(v * pw);
        pv = prod == prod ? prod : 0.0f;  // exactnum.block
        pr = pw > 0.0f ? flush(pw / v) : 0.0f;
        vf = pw;
        sf = q == 0 || srows[q] != srows[q - 1];
        const long long i = n - 1 - q;  // the flipped array's element q
        vb = sw[i];
        sb = q == 0 || srows[i + 1] != srows[i];
      }
      X(0, 0)[j] = pw;
      X(0, 1)[j] = pv;
      X(0, 2)[j] = pr;
      V(0, 0)[j] = vf;
      V(0, 1)[j] = vb;
      const int lane = j & (kChunk - 1);
      F(0, 0)[j] = (unsigned char)((sf || lane == 0) | (sf << 1));
      F(0, 1)[j] = (unsigned char)((sb || lane == 0) | (sb << 1));
      if (sf) atomicMin(&FIRST(0)[j / kChunk], lane);
      if (sb) atomicMin(&FIRST(1)[j / kChunk], lane);
    }
  }
  TD_SYNC();
  // the N-long scans (x + x[-s], the pad lanes adding +0.0) and the
  // in-chunk segmented scans (v = f ? v : v + v[-s]; f |= f[-s]; lanes
  // below the shift: v + 0.0, f | true), shift by shift together
  int cur = 0;
  for (int s = 1; (s < t && s < n) || s < kChunk; s <<= 1, cur ^= 1) {
    const bool dn = s < t && s < n, dc = s < kChunk;
    TD_SIMT {
#pragma unroll
      for (int r = 0; r < kE; ++r) {
        const int j = TD_TID + r * nt;
        if (j >= w) continue;
        const bool in = dn && base + j - s >= 0 && j - s >= 0;
        X(cur ^ 1, 0)[j] = X(cur, 0)[j] + (in ? X(cur, 0)[j - s] : 0.0f);
        X(cur ^ 1, 1)[j] =
            flush(X(cur, 1)[j] + (in ? X(cur, 1)[j - s] : 0.0f));
        X(cur ^ 1, 2)[j] =
            flush(X(cur, 2)[j] + (in ? X(cur, 2)[j - s] : 0.0f));
        if (!dn) {
          for (int k = 0; k < 3; ++k) X(cur ^ 1, k)[j] = X(cur, k)[j];
        }
        const bool ic = (j & (kChunk - 1)) >= s;
        for (int d = 0; d < 2; ++d) {
          const unsigned char fl = F(cur, d)[j];
          if (!dc) {
            V(cur ^ 1, d)[j] = V(cur, d)[j];
            F(cur ^ 1, d)[j] = fl;
            continue;
          }
          const bool f = fl & 1;
          const bool fp = ic ? (F(cur, d)[j - s] & 1) : true;
          V(cur ^ 1, d)[j] =
              f ? V(cur, d)[j]
                : V(cur, d)[j] + (ic ? V(cur, d)[j - s] : 0.0f);
          F(cur ^ 1, d)[j] = (unsigned char)((fl & 2) | (f || fp));
        }
      }
    }
    TD_SYNC();
  }
  // the chunks: last column and a real start
  TD_SIMT {
    for (int i = TD_TID; i < 2 * nc; i += nt) {
      const int d = i / nc, lc = i % nc;
      CV(0, d)[lc] = V(cur, d)[lc * kChunk + kChunk - 1];
      CF(0, d)[lc] = FIRST(d)[lc] < kChunk;
    }
  }
  TD_SYNC();
  // the cross-chunk carry's shifts below T / 128 (chunk positions before
  // 0: v + 0.0, f | true)
  const long long gc0 = t0 / kChunk - hc;
  int cc = 0;
  for (int s = 1; s < hc && s < g; s <<= 1, cc ^= 1) {
    TD_SIMT {
      for (int i = TD_TID; i < 2 * nc; i += nt) {
        const int d = i / nc, lc = i % nc;
        const bool real = gc0 + lc - s >= 0;
        const bool in = real && lc - s >= 0;
        const float v = CV(cc, d)[lc];
        const int f = CF(cc, d)[lc];
        CV(cc ^ 1, d)[lc] = f ? v : v + (in ? CV(cc, d)[lc - s] : 0.0f);
        CF(cc ^ 1, d)[lc] = f | (in ? CF(cc, d)[lc - s] : (int)!real);
      }
    }
    TD_SYNC();
  }
  // the tile's half of the window out
  const long long padded = (long long)g * kChunk;
  TD_SIMT {
    for (int j = t + TD_TID; j < w; j += nt) {
      const long long q = base + j;
      if (q < n) {
        o.pw[q] = X(cur, 0)[j];
        o.pvw[q] = X(cur, 1)[j];
        o.prc[q] = X(cur, 2)[j];
      }
      if (q < padded) {
        o.svf[q] = V(cur, 0)[j];
        o.svb[q] = V(cur, 1)[j];
      }
    }
    for (int lc = hc + TD_TID; lc < nc; lc += nt) {
      const long long ch = gc0 + lc;
      if (ch < g) {
        o.cvf[ch] = CV(cc, 0)[lc];
        o.cvb[ch] = CV(cc, 1)[lc];
        o.cff[ch] = CF(cc, 0)[lc];
        o.cfb[ch] = CF(cc, 1)[lc];
        o.fsf[ch] = FIRST(0)[lc];
        o.fsb[ch] = FIRST(1)[lc];
      }
    }
  }
#undef X
#undef V
#undef F
#undef CV
#undef CF
#undef FIRST
}

// one shift of the N-long scans (sn > 0) and of both cross-chunk carry
// scans (sg > 0), from the in buffers to the out buffers
__global__ void td_scan_step(int n, int sn, const float* iw, const float* iv,
                             const float* ir, float* ow, float* ov, float* orc,
                             int g, int sg, const float* icf, const int* iff,
                             const float* icb, const int* ifb, float* ocf,
                             int* off, float* ocb, int* ofb) {
  TD_GROUP(0, (int)blockDim.x);
  TD_SIMT {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long hi = n > g ? n : g;
    for (long long i = (long long)blockIdx.x * blockDim.x + TD_TID; i < hi;
         i += stride) {
      if (sn > 0 && i < n) {
        const bool in = i >= sn;
        ow[i] = iw[i] + (in ? iw[i - sn] : 0.0f);
        ov[i] = flush(iv[i] + (in ? iv[i - sn] : 0.0f));
        orc[i] = flush(ir[i] + (in ? ir[i - sn] : 0.0f));
      }
      if (sg > 0 && i < g) {
        const bool in = i >= sg;
        {
          const float v = icf[i];
          const int f = iff[i];
          ocf[i] = f ? v : v + (in ? icf[i - sg] : 0.0f);
          off[i] = f | (in ? iff[i - sg] : 1);
        }
        {
          const float v = icb[i];
          const int f = ifb[i];
          ocb[i] = f ? v : v + (in ? icb[i - sg] : 0.0f);
          ofb[i] = f | (in ? ifb[i - sg] : 1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: the rows

struct RowsArgs {
  const float* means; const float* weights;
  const float* dmin; const float* dmax; const float* drecip;
  int k; int c;
  const long long* srows; const float* sw; const float* raw; int n;
  const float* pw; const float* pvw; const float* prc;
  const float* svf; const float* cvf; const int* fsf;
  const float* svb; const float* cvb; const int* fsb;
  const float* tbl; int tlen;
  float* out_m; float* out_w; float* out_min; float* out_max;
  float* out_recip;
  float* st_w; float* st_min; float* st_max; float* st_sum; float* st_recip;
};

// upper_bound_rows by a warp: 32 probes a round, so log32 N dependent
// loads (uniform result; the group's threads all take part)
__device__ __forceinline__ long long warp_upper_bound(const long long* a,
                                                      long long n,
                                                      long long v) {
  long long lo = 0, hi = n;
  TD_VAR(unsigned, m);
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    TD_BALLOT(TD_R(m), lo + TD_LANE * step < hi &&
                           !(a[lo + TD_LANE * step] > v));
    const int cnt = td_popc(TD_U(m));
    if (cnt == 0) {
      hi = lo;
    } else {
      const long long p = lo + (cnt - 1) * step;
      lo = p + 1;
      const long long nx = p + step;
      hi = nx < hi ? nx : hi;
    }
  }
  return lo;
}

// the prefix of the first i samples (the plain version's pre_* = [0, scan])
__device__ __forceinline__ float pre(const float* scan, long long i) {
  return i == 0 ? 0.0f : scan[i - 1];
}

// segments.segmented_cumsum's result at q: the in-chunk value, plus the
// carry of the chunks before for the lanes before the chunk's first start
__device__ __forceinline__ float seg_at(const float* sv, const float* cv,
                                        const int* fs, long long q) {
  const long long ch = q / kChunk;
  const float v = sv[q];
  if ((int)(q & (kChunk - 1)) < fs[ch])
    return v + (ch > 0 ? cv[ch - 1] : 0.0f);
  return v;
}

__device__ __forceinline__ int sample_bucket(const RowsArgs& a,
                                             const float* tb, long long q) {
  const float seg = seg_at(a.svf, a.cvf, a.fsf, q);
  const float suf = seg_at(a.svb, a.cvb, a.fsb, a.n - 1 - q);
  const float w = a.sw[q];
  const float row_total = flush(flush(seg + suf) - w);
  const float ql = flush(flush(seg - w) / clamp_tiny(row_total));
  const int b = upper_bound(tb, a.tlen, ql);
  return b < a.c - 1 ? b : a.c - 1;
}

__host__ __device__ __forceinline__ size_t add_group_bytes(int c, bool wide,
                                                           int g) {
  return row_smem_bytes(2 * c, wide, g) + align16(4ull * c) + 4 * 32;
}

// one digest row by a group of g warps (first thread g0): its runs, the
// batch digest beside its centroids, the row routine, the scalars
template <bool WIDE>
__device__ __forceinline__ void add_row(const RowsArgs& a, const float* tb,
                                        unsigned char* base, long long row,
                                        int g, int g0) {
  const int c = a.c;
  const float inf = f_inf();
  const RowSmem rs = carve_row(base, 2 * c, WIDE, g);
  int* rstart = reinterpret_cast<int*>(base + row_smem_bytes(2 * c, WIDE, g));
  int* cnt = rstart + align16(4ull * c) / 4;
  const long long hi = warp_upper_bound(a.srows, a.n, row);
  const long long lo = row == 0 ? 0 : warp_upper_bound(a.srows, a.n, row - 1);
  const float seg_w = flush(pre(a.pw, hi) - pre(a.pw, lo));
  const bool has = seg_w > 0.0f;
  // the row's runs: a start where the bucket changes (the row's first
  // sample always); the first c starts kept, counted to c + 1
  TD_VAR(int, st);
  TD_VAR(unsigned, mask);
  int nr = 0;
  for (long long b0 = lo; has && b0 < hi && nr <= c; b0 += 32 * g) {
    TD_SIMT {
      const long long q = b0 + (TD_TID - g0);
      bool start = false;
      if (q < hi) {
        const int b = sample_bucket(a, tb, q);
        start = q == lo || b != sample_bucket(a, tb, q - 1);
      }
      TD_R(st) = start;
    }
    TD_BALLOT(TD_R(mask), TD_R(st));
    int total;
    if (WIDE) {
      TD_SIMT {
        if (TD_LANE == 0) cnt[(TD_TID - g0) >> 5] = td_popc(TD_R(mask));
      }
      TD_SYNC();
      total = 0;
      for (int w = 0; w < g; ++w) total += cnt[w];
    } else {
      total = td_popc(TD_U(mask));
    }
    TD_SIMT {
      if (TD_R(st)) {
        int rr = nr + td_popc(TD_R(mask) & ((1u << TD_LANE) - 1u));
        if (WIDE)
          for (int w = 0; w < ((TD_TID - g0) >> 5); ++w) rr += cnt[w];
        if (rr < c) rstart[rr] = (int)(b0 + (TD_TID - g0));
      }
    }
    nr += total;
    group_sync<WIDE>();
  }
  // the batch digest [c] beside the row's centroids: the 2c candidates
  const long long off = row * c;
  TD_SIMT {
    for (int j = TD_TID - g0; j < c; j += 32 * g) {
      rs.cm[rs.at(j)] = a.means[off + j];
      rs.cw[rs.at(j)] = a.weights[off + j];
      float bw = 0.0f, bmw = 0.0f;
      if (j < nr) {
        const long long s0 = rstart[j];
        const float sw0 = pre(a.pw, s0), sv0 = pre(a.pvw, s0);
        float ew = 0.0f, ev = 0.0f;
        if (j == nr - 1) {
          ew = pre(a.pw, hi);
          ev = pre(a.pvw, hi);
        } else if (j + 1 < c) {
          ew = pre(a.pw, rstart[j + 1]);
          ev = pre(a.pvw, rstart[j + 1]);
        }
        bw = flush(ew - sw0);
        bmw = flush(ev - sv0);
      }
      rs.cm[rs.at(c + j)] = bw > 0.0f ? flush(bmw / clamp_tiny(bw)) : inf;
      rs.cw[rs.at(c + j)] = bw;
    }
    if (TD_TID == g0) {
      const float seg_sum = flush(pre(a.pvw, hi) - pre(a.pvw, lo));
      const float seg_recip = flush(pre(a.prc, hi) - pre(a.prc, lo));
      const long long lo_c = lo < a.n - 1 ? lo : a.n - 1;
      const long long hi_c = hi - 1 > 0 ? hi - 1 : 0;
      const float seg_min = has ? a.raw[lo_c] : inf;
      const float seg_max = has ? a.raw[hi_c] : -inf;
      a.st_w[row] = seg_w;
      a.st_min[row] = seg_min;
      a.st_max[row] = seg_max;
      a.st_sum[row] = seg_sum;
      a.st_recip[row] = seg_recip;
      a.out_min[row] = xla_min(flush(a.dmin[row]), flush(seg_min));
      a.out_max[row] = xla_max(flush(a.dmax[row]), flush(seg_max));
      a.out_recip[row] = flush(flush(a.drecip[row]) + seg_recip);
    }
  }
  group_sync<WIDE>();
  row_compress<WIDE>(rs, 2 * c, c, tb, a.tlen, g, g0, a.out_m + off,
                     a.out_w + off);
}

// C <= 128: a warp a row, kWarps rows a block; wider: a block a row
// (one-warp rows: 64 registers, four blocks an SM, measured faster than
// 80 and three)
template <bool WIDE>
__global__ void TD_BOUNDS(WIDE ? 16 * 32 : kWarps * 32, WIDE ? 1 : 4)
    td_add_rows(RowsArgs a) {
  TD_DYNAMIC_SMEM(smem);
  float* tb = reinterpret_cast<float*>(smem);
  unsigned char* groups = smem + align16(4ull * a.tlen);
  TD_GROUP(0, (int)blockDim.x);
  TD_SIMT {
    for (int i = TD_TID; i < a.tlen; i += (int)blockDim.x) tb[i] = a.tbl[i];
  }
  TD_SYNC();
  const int g = WIDE ? (int)blockDim.x / 32 : 1;
  const size_t gb = add_group_bytes(a.c, WIDE, g);
  TD_FOR_GROUPS(grp, 32 * g) {
    const long long row =
        WIDE ? (long long)blockIdx.x
             : (long long)blockIdx.x * ((int)blockDim.x / 32) + grp;
    if (row < a.k)
      add_row<WIDE>(a, tb, groups + (size_t)grp * gb, row, g, grp * 32 * g);
  }
}

// ---------------------------------------------------------------------------
// K3: the staged fold (td_fold_warps; td_stage_rows past 256 candidates)

struct FoldArgs {
  const float* means; const float* weights;  // the pool's rows [s, c]
  const float* in[12];  // dmin, dmax, drecip(_c), lmin, lmax, lsum(_c),
                        // lweight(_c), lrecip(_c), each [s]
  const float* sv;      // staged values: flat [>= total], or dense [r, b]
  const float* sw;      // their weights; null: every weight 1.0 (flat)
  const int* off;       // flat: each row's first sample [s]; null: dense
  long long total;      // flat: the samples; dense: the plane's rows r
  long long s; int c; int b;
  const float* tbl; int tlen;
  float* out_m; float* out_w;  // [s, c]
  float* out_sc;               // the 12 new scalars [12, s]
  float* cand_m; float* cand_w;  // td_stage_rows: the candidates [s, c + b]
  int* paths;  // or null: td_fold_warps' rows by the path row_compress took
};

// where row r's staged samples start and how many of its b slots hold one
// (flat: its count, at most b; dense: all b below the plane's rows, none
// past them)
__device__ __forceinline__ void stage_row(const FoldArgs& a, long long r,
                                          long long& base, int& n) {
  if (a.off) {
    const long long o = a.off[r];
    const long long e = r + 1 < a.s ? (long long)a.off[r + 1] : a.total;
    base = o;
    n = e - o < a.b ? (int)(e - o) : a.b;
  } else {
    base = r * a.b;
    n = r < a.total ? a.b : 0;
  }
}

// slot j's raw value and weight: the sample's, or 0.0 and 0.0 past the
// row's count (the plain version's masked gather)
__device__ __forceinline__ void stage_slot(const FoldArgs& a, long long base,
                                           int n, int j, float& v,
                                           float& w) {
  v = 0.0f;
  w = 0.0f;
  if (j < n) {
    v = a.sv[base + j];
    w = a.sw ? a.sw[base + j] : 1.0f;
  }
}

// exactnum's int64 order keys of min and max (every NaN past every
// number, in the order that picks XLA's NaN), and back
constexpr long long kNanShift = 1ll << 33;
__device__ __forceinline__ long long bits_key(float x) {
  const int i = (int)__float_as_uint(x);
  return (long long)(i ^ ((i >> 31) & 0x7fffffff));
}
__device__ __forceinline__ float from_bits_key(long long k) {
  const int i = (int)k;
  return __uint_as_float((uint32_t)(i ^ ((i >> 31) & 0x7fffffff)));
}
__device__ __forceinline__ long long min_key(float x) {
  const long long k = bits_key(x);
  return x != x ? -kNanShift - k : k;
}
__device__ __forceinline__ long long max_key(float x) {
  const long long k = bits_key(x);
  return x != x ? kNanShift - k : k;
}
__device__ __forceinline__ float from_min_key(long long k) {
  return from_bits_key(k < -(1ll << 32) ? -kNanShift - k : k);
}
__device__ __forceinline__ float from_max_key(long long k) {
  return from_bits_key(k > (1ll << 32) ? kNanShift - k : k);
}

// core/worker._comp_add: the Neumaier add, every input and result flushed
__device__ __forceinline__ void comp_add(float s, float c, float x,
                                         float* t_out, float* c_out) {
  s = flush(s);
  c = flush(c);
  x = flush(x);
  const float t = flush(s + x);
  float r = fabsf(s) >= fabsf(x) ? flush(flush(s - t) + x)
                                 : flush(flush(x - t) + s);
  if ((__float_as_uint(t) & 0x7f800000u) == 0x7f800000u) r = 0.0f;
  *t_out = t;
  *c_out = flush(c + r);
}

// K3's row stats and the 12 new scalars of row r, by one warp: the
// staged slots j < b through ld(j, v, w) (raw bits), flushed; the sums
// of w, of v * w and of w / v over the live slots (w > 0) as
// exactnum.tsum's adjacent-pair halving trees over b padded with +0.0 to
// the power of two p: a tile of 32 slots a shuffle tree (lane i adds lane
// i + d, d = 1 .. 16, so lane 0 holds the tile's node), the tiles' nodes
// a binary counter of pending left nodes in stk [3][32] (lane 0's);
// every level flushed. The min and max: int64 order keys, exact in any
// order. The row's 12 scalars are read from in (shared memory, loaded
// with the row) or, in null, from the pool; lanes 0-3 each run one of
// the four flushed Neumaier adds and lanes 4-7 one XLA-order min or max
// merge, side by side
template <class LD>
__device__ __forceinline__ void stage_stats(const FoldArgs& a, LD ld,
                                            long long r, float* stk,
                                            const float* in) {
  const int b = a.b;
  const int p = pow2_at_least(b);
  const int tiles = p > 32 ? p / 32 : 1;
  const int width = p > 32 ? 32 : p;
  const float inf = f_inf();
  TD_VAR(float, xw);
  TD_VAR(float, xs);
  TD_VAR(float, xr);
  TD_VAR(float, ow);
  TD_VAR(float, os);
  TD_VAR(float, orc);
  TD_VAR(long long, kn);
  TD_VAR(long long, kx);
  TD_VAR(uint64_t, ok);
  TD_SIMT {
    TD_R(kn) = min_key(inf);
    TD_R(kx) = max_key(-inf);
  }
  for (int t = 0; t < tiles; ++t) {
    TD_SIMT {
      const int j = t * 32 + TD_LANE;
      float fw = 0.0f, fs = 0.0f, fr = 0.0f;
      if (j < b) {
        float v, w;
        ld(j, v, w);
        v = flush(v);
        w = flush(w);
        fw = w;
        if (w > 0.0f) {
          fs = flush(v * w);
          fr = flush(w / v);
          const long long kmn = min_key(v), kmx = max_key(v);
          if (kmn < TD_R(kn)) TD_R(kn) = kmn;
          if (kmx > TD_R(kx)) TD_R(kx) = kmx;
        }
      }
      TD_R(xw) = fw;
      TD_R(xs) = fs;
      TD_R(xr) = fr;
    }
    for (int d = 1; d < width; d <<= 1) {
      TD_SHFL(float, TD_R(ow), TD_R(xw), TD_LANE + d);
      TD_SHFL(float, TD_R(os), TD_R(xs), TD_LANE + d);
      TD_SHFL(float, TD_R(orc), TD_R(xr), TD_LANE + d);
      TD_SIMT {
        TD_R(xw) = flush(TD_R(xw) + TD_R(ow));
        TD_R(xs) = flush(TD_R(xs) + TD_R(os));
        TD_R(xr) = flush(TD_R(xr) + TD_R(orc));
      }
    }
    TD_SIMT {
      if (TD_LANE == 0) {
        float cw = TD_R(xw), cs = TD_R(xs), cr = TD_R(xr);
        int l = 0;
        for (; (t >> l) & 1; ++l) {
          cw = flush(stk[l] + cw);
          cs = flush(stk[32 + l] + cs);
          cr = flush(stk[64 + l] + cr);
        }
        stk[l] = cw;
        stk[32 + l] = cs;
        stk[64 + l] = cr;
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    TD_SHFL(uint64_t, TD_R(ok), (uint64_t)TD_R(kn), TD_LANE ^ d);
    TD_SIMT {
      if ((long long)TD_R(ok) < TD_R(kn)) TD_R(kn) = (long long)TD_R(ok);
    }
    TD_SHFL(uint64_t, TD_R(ok), (uint64_t)TD_R(kx), TD_LANE ^ d);
    TD_SIMT {
      if ((long long)TD_R(ok) > TD_R(kx)) TD_R(kx) = (long long)TD_R(ok);
    }
  }
  TD_SYNCWARP();  // lane 0's counter, read by lanes 0-3
  TD_SIMT {
    int lv = 0;
    while ((1 << lv) < tiles) ++lv;
    const int j = TD_LANE;
    if (j < 8) {
      auto at = [&](int k) { return in ? in[k] : a.in[k][r]; };
      float* o = a.out_sc + r;
      const long long s = a.s;
      if (j < 4) {
        // drecip, lsum, lweight, lrecip: inputs 2, 6, 8, 10 (and their
        // compensations), addends s_recip, s_sum, s_w, s_recip
        const int k = j ? 4 + 2 * j : 2;
        const float x = stk[(j == 1 ? 32 : j == 2 ? 0 : 64) + lv];
        comp_add(at(k), at(k + 1), x, o + k * s, o + (k + 1) * s);
      } else {
        // dmin, dmax, lmin, lmax: inputs 0, 1, 4, 5
        const int k = (j - 4) + (j >= 6 ? 2 : 0);
        o[k * s] = (j & 1) ? flush(xla_max(at(k), from_max_key(TD_R(kx))))
                           : flush(xla_min(at(k), from_min_key(TD_R(kn))));
      }
    }
  }
  TD_SYNCWARP();
}

// a warp's stage_stats counter [3][32], then td_fold_warps' two row
// buffers' 12 scalars (16 floats each)
constexpr int kStkBytes = (3 * 32 + 2 * 16) * 4;

// C + B <= 256: a warp a row, rpw consecutive rows a warp, the next row's
// candidates (the pool row's C means and weights, then its B staged
// slots) loaded (cp.async) while this one's stats are taken and it is
// compressed
// (4 blocks an SM, 64 registers, spill 208 B where 3 spill 144: 2% faster,
// not taken while it spills)
constexpr int kFoldBlocks = 3;
__global__ void TD_BOUNDS(kWarps * 32, kFoldBlocks)
    td_fold_warps(FoldArgs a, int rpw) {
  TD_DYNAMIC_SMEM(smem);
  float* tb = reinterpret_cast<float*>(smem);
  TD_GROUP(0, (int)blockDim.x);
  TD_SIMT {
    for (int i = TD_TID; i < a.tlen; i += (int)blockDim.x) tb[i] = a.tbl[i];
  }
  TD_SYNC();
  const int nw = (int)blockDim.x / 32;
  const int c = a.c, m = a.c + a.b;
  const size_t rb = row_smem_bytes(m, false, 1);
  TD_FOR_GROUPS(w, 32) {
    unsigned char* base =
        smem + align16(4ull * a.tlen) + (size_t)w * (2 * rb + kStkBytes);
    float* stk = reinterpret_cast<float*>(base + 2 * rb);
    const long long first = ((long long)blockIdx.x * nw + w) * rpw;
    const long long last = first + rpw < a.s ? first + rpw : a.s;
    for (long long row = first; row < last; ++row) {
      // row + 1 loads into the other buffer while row is folded
      for (long long ld = row == first ? row : row + 1;
           ld <= row + 1 && ld < last; ++ld) {
        const RowSmem d = carve_row(base + ((ld - first) & 1) * rb, m,
                                    false, 1);
        long long sb;
        int n;
        stage_row(a, ld, sb, n);
        float* sc = stk + 96 + ((ld - first) & 1) * 16;
        TD_SIMT {
          if (TD_LANE < 12) cp_async4(sc + TD_LANE, a.in[TD_LANE] + ld);
          for (int i = TD_LANE; i < c; i += 32) {
            cp_async4(d.cm + d.at(i), a.means + ld * c + i);
            cp_async4(d.cw + d.at(i), a.weights + ld * c + i);
          }
          for (int j = TD_LANE; j < a.b; j += 32) {
            const int at = d.at(c + j);
            if (j < n) {
              cp_async4(d.cm + at, a.sv + sb + j);
              if (a.sw) cp_async4(d.cw + at, a.sw + sb + j);
              else d.cw[at] = 1.0f;
            } else {
              d.cm[at] = 0.0f;
              d.cw[at] = 0.0f;
            }
          }
          cp_async_commit();
        }
      }
      TD_SIMT {
        if (row + 1 < last) cp_async_wait<1>();
        else cp_async_wait<0>();
      }
      TD_SYNCWARP();
      const RowSmem cur = carve_row(base + ((row - first) & 1) * rb, m,
                                    false, 1);
      stage_stats(a,
                  [&](int j, float& v, float& wt) {
                    v = cur.cm[cur.at(c + j)];
                    wt = cur.cw[cur.at(c + j)];
                  },
                  row, stk, stk + 96 + ((row - first) & 1) * 16);
      const int path = row_compress<false, true>(
          cur, m, c, tb, a.tlen, 1, w * 32, a.out_m + row * c,
          a.out_w + row * c);
      if (a.paths) {
        TD_SIMT {
          if (TD_LANE == 0) atomicAdd(a.paths + path, 1);
        }
      }
    }
  }
}

// C + B > 256: a warp a row writes its candidates [c + b] (the pool
// row's, then the staged slots) and its 12 new scalars; K2a's block or
// slab kernel compresses the candidates after it
__global__ void TD_BOUNDS(kWarps * 32, 4) td_stage_rows(FoldArgs a) {
  TD_DYNAMIC_SMEM(smem);
  TD_GROUP(0, (int)blockDim.x);
  const int nw = (int)blockDim.x / 32;
  const int c = a.c;
  const long long m = a.c + a.b;
  TD_FOR_GROUPS(w, 32) {
    const long long row = (long long)blockIdx.x * nw + w;
    if (row < a.s) {
      float* stk = reinterpret_cast<float*>(smem + (size_t)w * kStkBytes);
      long long sb;
      int n;
      stage_row(a, row, sb, n);
      TD_SIMT {
        for (int i = TD_LANE; i < c; i += 32) {
          a.cand_m[row * m + i] = a.means[row * c + i];
          a.cand_w[row * m + i] = a.weights[row * c + i];
        }
      }
      stage_stats(a,
                  [&](int j, float& v, float& wt) {
                    stage_slot(a, sb, n, j, v, wt);
                    a.cand_m[row * m + c + j] = v;
                    a.cand_w[row * m + c + j] = wt;
                  },
                  row, stk, nullptr);
    }
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
#ifdef TD_EMULATE
  (void)kernel;
  return 0;
#else
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
#endif
}

int scan_tile(int n) {
  const int p = pow2_at_least(n);
  return p < kChunk ? kChunk : (p > kScanTile ? kScanTile : p);
}

struct AddScratch {
  uint64_t* hi[2];
  uint32_t* lo[2];
  Sorted srt;
  float* scan[2][3];
  float* svf; float* svb;
  float* cvf[2]; float* cvb[2];
  int* cff[2]; int* cfb[2];
  int* fsf; int* fsb;
  size_t bytes;
};

AddScratch carve_add(unsigned char* base, int n) {
  const int g = (n + kChunk - 1) / kChunk;
  AddScratch s;
  size_t at = 0;
  auto take = [&](size_t b) {
    unsigned char* p = base ? base + at : nullptr;
    at += align16(b);
    return p;
  };
  for (int i = 0; i < 2; ++i) {
    s.hi[i] = reinterpret_cast<uint64_t*>(take(8ull * n));
    s.lo[i] = reinterpret_cast<uint32_t*>(take(4ull * n));
  }
  s.srt.srows = reinterpret_cast<long long*>(take(8ull * n));
  s.srt.svals = reinterpret_cast<float*>(take(4ull * n));
  s.srt.sw = reinterpret_cast<float*>(take(4ull * n));
  s.srt.raw = reinterpret_cast<float*>(take(4ull * n));
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j)
      s.scan[i][j] = reinterpret_cast<float*>(take(4ull * n));
  s.svf = reinterpret_cast<float*>(take(4ull * g * kChunk));
  s.svb = reinterpret_cast<float*>(take(4ull * g * kChunk));
  for (int i = 0; i < 2; ++i) {
    s.cvf[i] = reinterpret_cast<float*>(take(4ull * g));
    s.cvb[i] = reinterpret_cast<float*>(take(4ull * g));
    s.cff[i] = reinterpret_cast<int*>(take(4ull * g));
    s.cfb[i] = reinterpret_cast<int*>(take(4ull * g));
  }
  s.fsf = reinterpret_cast<int*>(take(4ull * g));
  s.fsb = reinterpret_cast<int*>(take(4ull * g));
  s.bytes = at;
  return s;
}

}  // namespace

extern "C" {

// the bytes of one row's buffers in the global slab; past a block's
// shared memory (td_compress_smem_limit) where the row is wider than a
// block's warps sort, and then the caller passes a global slab of s of
// them and the launcher takes the slab kernel
long long td_compress_row_bytes(int m) {
  const int p = pow2_at_least(m);
  const long long b = (long long)slab_bytes(m, p);
  return p > kMaxGroupKeys && b <= (long long)kMaxSmem
             ? (long long)kMaxSmem + 1 : b;
}

int td_compress_smem_limit() { return (int)kMaxSmem; }

int td_compress_launch(const float* means, const float* weights, long long s,
                       int m, int c, const float* tbl, int tlen,
                       unsigned char* scratch, float* out_m, float* out_w,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t tb = align16(4ull * tlen);
  int e;
  if (scratch || pow2_at_least(m) > kMaxGroupKeys) {
    const int p = pow2_at_least(m);
    TD_LAUNCH(td_compress_scratch, (unsigned)s,
              p >= 512 ? 256 : (p >= 64 ? p / 2 : 32), 0, st, means,
              weights, m, c, tbl, tlen, scratch, out_m, out_w);
  } else if (m <= kSpan) {
    const size_t smem = tb + (size_t)kWarps * 2 * row_smem_bytes(m, false, 1);
    if ((e = set_smem((const void*)td_compress_warps, smem))) return e;
    // rows a warp (loaded ahead) where there are rows enough to fill the
    // card with blocks; else one, for more blocks
    const int rpw = s >= 32768 ? kRowsPerWarp : 1;
    const long long per = (long long)kWarps * rpw;
    TD_LAUNCH(td_compress_warps, (unsigned)((s + per - 1) / per),
              kWarps * 32, smem, st, means, weights, s, m, c, tbl, tlen,
              out_m, out_w, rpw);
  } else {
    const int g = group_warps(m);
    const size_t smem = tb + row_smem_bytes(m, true, g);
    if ((e = set_smem((const void*)td_compress_wide, smem))) return e;
    TD_LAUNCH(td_compress_wide, (unsigned)s, 32 * g, smem, st, means,
              weights, m, c, tbl, tlen, out_m, out_w);
  }
  return (int)cudaGetLastError();
}

// the bytes of K2b's global scratch for a batch of n samples
long long td_add_batch_scratch_bytes(int n) {
  return (long long)carve_add(nullptr, n).bytes;
}

// the launches of K2b for a batch of n samples (the chain's length)
int td_add_batch_launches(int n) {
  int l = 1;
  for (long long len = kSortTile; len < n; len <<= 1) ++l;
  const int t = scan_tile(n), g = (n + kChunk - 1) / kChunk;
  ++l;
  for (int sn = t, sg = t / kChunk; sn < n || sg < g; sn <<= 1, sg <<= 1)
    ++l;
  return l + 1;
}

int td_add_batch_launch(const float* means, const float* weights,
                        const float* dmin, const float* dmax,
                        const float* drecip, int k, int c, const void* rows,
                        int rows64, const float* values,
                        const float* sample_weights, int n, const float* tbl,
                        int tlen, unsigned char* scratch, float* out_m,
                        float* out_w, float* out_min, float* out_max,
                        float* out_recip, float* st_w, float* st_min,
                        float* st_max, float* st_sum, float* st_recip,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const AddScratch s = carve_add(scratch, n);
  const Batch b{rows, rows64, values, sample_weights, n, k};
  int e;
  // the sort: tiles, then merge passes; the last writes the sorted batch
  int passes = 0;
  for (long long len = kSortTile; len < n; len <<= 1) ++passes;
  const unsigned tiles = (unsigned)((n + kSortTile - 1) / kSortTile);
  const size_t sort_smem = 24 * (size_t)kSortTile;
  TD_LAUNCH(td_sort_tile, tiles, kWarps * 32, sort_smem, st, b, s.hi[0],
            s.lo[0], s.srt, passes == 0);
  if ((e = (int)cudaGetLastError())) return e;
  int cur = 0;
  const size_t merge_smem = 12 * (size_t)kMergeOut + 16;
  for (long long len = kSortTile; len < n; len <<= 1, cur ^= 1) {
    TD_LAUNCH(td_sort_merge, (unsigned)((n + kMergeOut - 1) / kMergeOut),
              kMergeOut / kE, merge_smem, st, b,
              s.hi[cur], s.lo[cur], s.hi[cur ^ 1], s.lo[cur ^ 1], len, s.srt,
              2 * len >= n);
    if ((e = (int)cudaGetLastError())) return e;
  }
  // the scans
  const int g = (n + kChunk - 1) / kChunk;
  const int t = scan_tile(n);
  const ScanBufs o{s.scan[0][0], s.scan[0][1], s.scan[0][2], s.svf, s.svb,
                   s.cvf[0], s.cff[0], s.fsf, s.cvb[0], s.cfb[0], s.fsb};
  const size_t scan_smem = scan_tile_smem(t);
  if ((e = set_smem((const void*)td_scan_tile, scan_smem))) return e;
  TD_LAUNCH(td_scan_tile, (unsigned)((n + t - 1) / t),
            2 * t < 1024 ? 2 * t : 1024, scan_smem, st, s.srt.srows,
            s.srt.svals, s.srt.sw, n, g, t, o);
  if ((e = (int)cudaGetLastError())) return e;
  int an = 0, ag = 0;  // which buffer holds each scan
  for (int sn = t, sg = t / kChunk; sn < n || sg < g; sn <<= 1, sg <<= 1) {
    const int dn = sn < n ? sn : 0, dg = sg < g ? sg : 0;
    const long long work = n > g ? n : g;
    const int blocks = (int)((work + 255) / 256 < 65535 ? (work + 255) / 256
                                                        : 65535);
    TD_LAUNCH(td_scan_step, blocks, 256, 0, st, n, dn, s.scan[an][0],
              s.scan[an][1], s.scan[an][2], s.scan[an ^ 1][0],
              s.scan[an ^ 1][1], s.scan[an ^ 1][2], g, dg, s.cvf[ag],
              s.cff[ag], s.cvb[ag], s.cfb[ag], s.cvf[ag ^ 1], s.cff[ag ^ 1],
              s.cvb[ag ^ 1], s.cfb[ag ^ 1]);
    if ((e = (int)cudaGetLastError())) return e;
    if (dn) an ^= 1;
    if (dg) ag ^= 1;
  }
  // the rows
  RowsArgs a{means, weights, dmin, dmax, drecip, k, c, s.srt.srows, s.srt.sw,
             s.srt.raw, n, s.scan[an][0], s.scan[an][1], s.scan[an][2],
             s.svf, s.cvf[ag], s.fsf, s.svb, s.cvb[ag], s.fsb, tbl, tlen,
             out_m, out_w, out_min, out_max, out_recip, st_w, st_min, st_max,
             st_sum, st_recip};
  const size_t tb = align16(4ull * tlen);
  if (2 * c <= kSpan) {
    const size_t smem = tb + kWarps * add_group_bytes(c, false, 1);
    if ((e = set_smem((const void*)td_add_rows<false>, smem))) return e;
    TD_LAUNCH(td_add_rows<false>, (unsigned)((k + kWarps - 1) / kWarps),
              kWarps * 32, smem, st, a);
  } else {
    const int gw = group_warps(2 * c);
    const size_t smem = tb + add_group_bytes(c, true, gw);
    if ((e = set_smem((const void*)td_add_rows<true>, smem))) return e;
    TD_LAUNCH(td_add_rows<true>, (unsigned)k, 32 * gw, smem, st, a);
  }
  return (int)cudaGetLastError();
}

// K3: the staged fold's widest one-warp row (C + B past it takes
// td_stage_rows, then td_compress_launch over its candidates)
int td_fold_span() { return kSpan; }

int td_fold_staged_launch(const float* means, const float* weights,
                          const float* const* in, long long s, int c, int b,
                          const float* sv, const float* sw, const int* off,
                          long long total, const float* tbl, int tlen,
                          float* out_m, float* out_w, float* out_sc,
                          float* cand_m, float* cand_w, int* paths,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  FoldArgs a;
  a.means = means;
  a.weights = weights;
  for (int k = 0; k < 12; ++k) a.in[k] = in[k];
  a.sv = sv;
  a.sw = sw;
  a.off = off;
  a.total = total;
  a.s = s;
  a.c = c;
  a.b = b;
  a.tbl = tbl;
  a.tlen = tlen;
  a.out_m = out_m;
  a.out_w = out_w;
  a.out_sc = out_sc;
  a.cand_m = cand_m;
  a.cand_w = cand_w;
  a.paths = paths;
  const int m = c + b;
  int e;
  if (m <= kSpan) {
    const size_t smem = align16(4ull * tlen) +
                        (size_t)kWarps * (2 * row_smem_bytes(m, false, 1) +
                                          kStkBytes);
    if ((e = set_smem((const void*)td_fold_warps, smem))) return e;
    const int rpw = s >= 32768 ? kRowsPerWarp : 1;
    const long long per = (long long)kWarps * rpw;
    TD_LAUNCH(td_fold_warps, (unsigned)((s + per - 1) / per), kWarps * 32,
              smem, st, a, rpw);
  } else {
    TD_LAUNCH(td_stage_rows, (unsigned)((s + kWarps - 1) / kWarps),
              kWarps * 32, (size_t)kWarps * kStkBytes, st, a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
