// Flush extract for Hopper (sm_90a): quantiles and the ten per-row
// aggregate columns of a t-digest pool, packed into one f32[S, P+10] array.
//
// Replaces the TPU kernel veneur_tpu/ops/pallas_kernels.py:_extract_kernel
// (pl.pallas_call in flush_extract) and computes what the XLA flush path
// computes: veneur_tpu/core/worker.py _histo_flush_extract followed by
// _pack_extract_columns. Column layout per row:
//   [0, P)  quantile qs[j] of the digest row
//   P+0 dmin  P+1 dmax  P+2 dsum  P+3 dcount  P+4 drecip + drecip_c
//   P+5 lmin  P+6 lmax  P+7 lsum + lsum_c  P+8 lweight + lweight_c
//   P+9 lrecip + lrecip_c
//
// Bit contract: the XLA path's, not the Pallas kernel's. The Pallas kernel
// takes its cumsum as a triangular matmul on the matrix unit and is only
// close to the XLA path; this kernel leaves the tensor cores unused for the
// same reason. So:
//   * cumulative weight is the Hillis-Steele scan of ops/exactnum.cumsum,
//     x[i] + x[i - s] for s = 1, 2, 4, ..., 64, the lanes i < s adding 0.0f;
//   * dsum and dcount are the adjacent-pair halving tree of exactnum.tsum;
//   * target = qs[j] * total is rounded to f32 (exactnum.block: NaN -> 0);
//   * the slot is searchsorted(w_cum, target, side="left") clamped to
//     C - 1, taken as the same lower-bound binary search (probe order and
//     `!(w_cum[mid] >= target)` test) as torch.searchsorted. The scan is not
//     monotone in general: with non-integer weights two prefixes may round
//     apart by an ulp, and then a count of w_cum < target is another slot;
//   * proportion = (target - w_before) / max(w_at, 1e-30f),
//     out = lb + block(proportion * (ub - lb)), NaN where
//     !(total > 0 && count > 0).
// Built with -fmad=false and without fast math, so no product is fused
// into an add and f32 division is correctly rounded.
//
// Denormals: XLA on the CPU runs with denormals-are-zero and flush-to-zero,
// so an f32 denormal that arithmetic or a comparison reads counts as a zero
// of its sign, and every denormal result, inside the arithmetic as in the
// outputs, is written as one; a copy passes the bits. This source is built
// with -ftz=true (ops/nvcc.py EXTRACT_FLAGS), which puts .ftz on every f32
// add, mul, div, setp, min and max, and that is exactly this rule: no
// select is needed at any load or store. dmin, dmax, lmin and lmax leave as
// loaded (moves keep their bits), as in the plain version
// (ops/extract_kernel.py, ops/tdigest.py).
//
// Bound: memory. Per row it reads 2 x 128 x 4 B of centroids plus 12
// scalars and writes P + 10 floats; at S = 1,048,576 and P = 3 that is
// about 1.18 GB, 0.35 ms at the H100's 3.35 TB/s. The arithmetic (about a
// thousand f32 operations per row) needs a tenth of that time at the f32
// rate, so what stands between a kernel and the bound is the instruction
// stream (shuffles, ballots, divides repeated on every lane) and the bytes
// in flight.
//
// Design, against both:
//   * R rows per warp, L = 32 / R lanes per row, E = 128 / L contiguous
//     centroids per lane. A row's lanes are strided, lane = g + R * gl for
//     row g of the warp's chunk and place gl in the row, so a shuffle by
//     d * R lanes moves a value d places along every row of the warp at
//     once. Scan steps s < E run inside the lane (one shuffle of the
//     elements that cross into the next lane), steps s >= E shuffle whole
//     lanes; the trees pair in-lane levels first, then shuffle down. Per
//     row that is about R times fewer shuffles than one warp per row, and
//     the quantile arithmetic runs on one lane per (row, quantile) instead
//     of on all 32.
//   * The slot search and the gathers at the slot read shared memory: the
//     row's means and weights are there already, and the scan writes w_cum
//     beside them. A register array indexed by a runtime slot would go to
//     local memory.
//   * Each warp runs its own ring of NS stages in shared memory. Lane g
//     brings row g of a chunk in with cp.async.bulk (Hopper's 1-D bulk
//     copy, no tensor map), 512 B of means and 512 B of weights, completing
//     on the stage's mbarrier; the warp starts chunk i + NS - 1 before it
//     waits for chunk i, so NS - 1 chunks load while one computes. The
//     grid is persistent: every SM holds as many blocks as the occupancy
//     calculator allows, and warps stride over the chunks.
//   * Rows sit 528 B apart in shared memory (16 B of pad, one copy per
//     row), so the 16-byte reads of the eight lanes of a quarter warp fall
//     on eight different bank groups for every R: no bank conflicts.
//   * The row scalars are loaded by the row's first lane (lane g reads row
//     g of the chunk) before the wait, and the chunk's output rows are
//     staged in shared memory and written as one contiguous run of
//     16-byte stores (4-byte stores where the run is not 16-byte aligned).
//   * Any number of quantiles: at P <= 16 flush_extract_kernel stages a
//     chunk's whole output rows and writes them as one run. Past 16,
//     flush_extract_wide_kernel does the same row work once (each row is
//     read and scanned once) and then walks the quantiles in blocks of 16,
//     each block's columns staged in the same shared-memory rows and
//     written as one 64-byte run per row, the ten aggregate columns after
//     the last block. Both compute every quantile column by the same
//     arithmetic, so a column's bits do not depend on P.
// The variants R = 1, 2, 4, 8 are template instances, each behind its own
// launchers; ops/extract_kernel.py names the one flush_extract launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCap = 128;  // centroids per row
constexpr int kMaxP = 16;  // the narrow kernel's P at most; the wide
                           // kernel's block of quantiles
constexpr int kAgg = 10;   // aggregate columns after the quantiles
constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRowStride = kCap + 4;  // floats between rows in shared memory
constexpr int kRowBytes = kCap * 4;   // one row of means or weights
constexpr unsigned kFull = 0xffffffffu;

struct Fields {
  const float* means;
  const float* weights;
  const float* dmin;
  const float* dmax;
  const float* drecip;
  const float* drecip_c;
  const float* lmin;
  const float* lmax;
  const float* lsum;
  const float* lsum_c;
  const float* lweight;
  const float* lweight_c;
  const float* lrecip;
  const float* lrecip_c;
  const float* qs;
  float* out;
};

template <int R>
struct Cfg {
  static constexpr int L = 32 / R;    // lanes per row
  static constexpr int E = kCap / L;  // centroids per lane
  // stages of the warp's ring: about 16 rows of each array per warp
  static constexpr int NS = R == 1 ? 8 : R == 2 ? 5 : R == 4 ? 3 : 2;
  static constexpr int kArrayBytes = R * kRowStride * 4;  // R padded rows
  static constexpr int kStageBytes = 2 * kArrayBytes;     // means, weights
  static constexpr int kOutBytes = (R * (kMaxP + kAgg) * 4 + 15) / 16 * 16;
  static constexpr int kWarpBytes =
      (NS * kStageBytes + kArrayBytes + kOutBytes + NS * 8 + 127) / 128 * 128;
  static constexpr int kBlockBytes = kWarps * kWarpBytes;
  static_assert(R == 1 || R == 2 || R == 4 || R == 8, "R divides 32");
  static_assert(E % 4 == 0, "a lane reads whole float4s");
  static_assert(kBlockBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival that also tells the barrier how many bytes will land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// jnp.maximum(x, 1e-30): NaN propagates
__device__ __forceinline__ float max_tiny(float x) {
  const float tiny = 1e-30f;
  return (x != x) ? x : (x < tiny ? tiny : x);
}

// adjacent-pair halving tree over a lane's N values
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

// one Hillis-Steele step x[i] += x[i - S] over the row's 128 slots; lane
// place gl holds slots gl*E .. gl*E + E - 1, and place gl - d sits d*R
// lanes below
template <int E, int R, int S>
__device__ __forceinline__ void scan_step(float (&x)[E], int gl) {
  float y[E];
  if constexpr (S < E) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e >= S) {
        y[e] = x[e] + x[e - S];
      } else {
        const float up = __shfl_up_sync(kFull, x[E - S + e], R);
        y[e] = x[e] + (gl >= 1 ? up : 0.0f);
      }
    }
  } else {
    constexpr int D = S / E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float up = __shfl_up_sync(kFull, x[e], D * R);
      y[e] = x[e] + (gl >= D ? up : 0.0f);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = y[e];
}

template <int E, int R, int S = 1>
__device__ __forceinline__ void hillis_steele(float (&x)[E], int gl) {
  if constexpr (S < kCap) {
    scan_step<E, R, S>(x, gl);
    hillis_steele<E, R, 2 * S>(x, gl);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    flush_extract_kernel(const Fields f, int S, int P) {
  using C = Cfg<R>;
  constexpr int L = C::L, E = C::E, NS = C::NS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* base = smem + warp * C::kWarpBytes;
  float* stages = reinterpret_cast<float*>(base);
  float* cws = reinterpret_cast<float*>(base + NS * C::kStageBytes);
  float* outs = reinterpret_cast<float*>(base + NS * C::kStageBytes +
                                         C::kArrayBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      base + NS * C::kStageBytes + C::kArrayBytes + C::kOutBytes);

  const int g = lane & (R - 1);  // the chunk row this lane works on
  const int gl = lane / R;       // the lane's place within that row
  const long long nchunks = ((long long)S + R - 1) / R;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  const int ncol = P + kAgg;
  const float qnan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // bring chunk `chunk` into stage `stage` (warp-uniform call)
  auto fetch = [&](long long chunk, int stage) {
    if (chunk >= nchunks) return;
    const long long row0 = chunk * R;
    const int rows = (int)(S - row0 < R ? S - row0 : R);
    float* sm = stages + stage * (C::kStageBytes / 4);
    if (lane == 0) {
      // the warp's reads of this stage (ordered by the last __syncwarp)
      // come before the bulk copy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect(&bars[stage], (uint32_t)(rows * 2 * kRowBytes));
    }
    __syncwarp();
    if (lane < rows) {
      bulk_load(sm + lane * kRowStride, f.means + (row0 + lane) * kCap,
                kRowBytes, &bars[stage]);
      bulk_load(sm + (R + lane) * kRowStride,
                f.weights + (row0 + lane) * kCap, kRowBytes, &bars[stage]);
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) fetch(first + s * stride, s);

  int stage = 0;
  uint32_t phase = 0;
  for (long long chunk = first; chunk < nchunks; chunk += stride) {
    fetch(chunk + (NS - 1) * stride, stage == 0 ? NS - 1 : stage - 1);
    const long long row0 = chunk * R;
    const int rows = (int)(S - row0 < R ? S - row0 : R);
    const long long row = row0 + g;

    // the row's scalars, on its first lane (lane == g), before the wait
    float sc[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) sc[k] = 0.0f;
    if (gl == 0 && g < rows) {
      sc[0] = __ldg(f.dmin + row);
      sc[1] = __ldg(f.dmax + row);
      sc[2] = __ldg(f.drecip + row);
      sc[3] = __ldg(f.drecip_c + row);
      sc[4] = __ldg(f.lmin + row);
      sc[5] = __ldg(f.lmax + row);
      sc[6] = __ldg(f.lsum + row);
      sc[7] = __ldg(f.lsum_c + row);
      sc[8] = __ldg(f.lweight + row);
      sc[9] = __ldg(f.lweight_c + row);
      sc[10] = __ldg(f.lrecip + row);
      sc[11] = __ldg(f.lrecip_c + row);
    }

    mbar_wait(&bars[stage], phase);
    const float* mrow = stages + stage * (C::kStageBytes / 4) + g * kRowStride;
    const float* wrow = mrow + R * kRowStride;
    float* crow = cws + g * kRowStride;

    float w[E];
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(wrow + gl * E)[k];
      w[4 * k] = t.x;
      w[4 * k + 1] = t.y;
      w[4 * k + 2] = t.z;
      w[4 * k + 3] = t.w;
    }

    // number of nonempty slots, on every lane of the row
    int count = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) count += w[e] > 0.0f ? 1 : 0;
#pragma unroll
    for (int off = L / 2; off >= 1; off >>= 1)
      count += __shfl_xor_sync(kFull, count, off * R);

    // dsum and dcount: in-lane tree levels, then across the row's lanes;
    // the sums land on the row's first lane
    float vc = tree_sum<E>(w);
    float vs;
    {
      float pr[E];
#pragma unroll
      for (int k = 0; k < E / 4; ++k) {
        const float4 t = reinterpret_cast<const float4*>(mrow + gl * E)[k];
        const float m4[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wi = w[4 * k + i];
          pr[4 * k + i] = wi > 0.0f ? m4[i] * wi : 0.0f;
        }
      }
      vs = tree_sum<E>(pr);
    }
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
      vs = vs + __shfl_down_sync(kFull, vs, off * R);
      vc = vc + __shfl_down_sync(kFull, vc, off * R);
    }

    // cumulative weight, in place; then beside the row in shared memory
    hillis_steele<E, R>(w, gl);
    const float total = __shfl_sync(kFull, w[E - 1], g + (L - 1) * R);
#pragma unroll
    for (int k = 0; k < E / 4; ++k)
      reinterpret_cast<float4*>(crow + gl * E)[k] =
          make_float4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);

    const float rmin = __shfl_sync(kFull, sc[0], g);
    const float rmax = __shfl_sync(kFull, sc[1], g);
    float* orow = outs + g * ncol;
    if (gl == 0) {
      orow[P + 0] = sc[0];
      orow[P + 1] = sc[1];
      orow[P + 2] = vs;
      orow[P + 3] = vc;
      orow[P + 4] = sc[2] + sc[3];
      orow[P + 5] = sc[4];
      orow[P + 6] = sc[5];
      orow[P + 7] = sc[6] + sc[7];
      orow[P + 8] = sc[8] + sc[9];
      orow[P + 9] = sc[10] + sc[11];
    }
    __syncwarp();

    // quantile j of row g on lane place gl = j mod L
    const bool live = total > 0.0f && count > 0;
    const int last = count - 1;
    for (int j = gl; j < P; j += L) {
      float target = __ldg(f.qs + j) * total;
      target = (target == target) ? target : 0.0f;
      int lo = 0, hi = kCap;
#pragma unroll
      for (int it = 0; it < 8; ++it) {  // 8 halvings empty [0, 128)
        if (lo < hi) {
          const int mid = lo + ((hi - lo) >> 1);
          if (!(crow[mid] >= target))
            lo = mid + 1;
          else
            hi = mid;
        }
      }
      const int idx = lo < kCap - 1 ? lo : kCap - 1;
      const float w_at = wrow[idx];
      const float cw_at = crow[idx];
      const float m_at = mrow[idx];
      // ub = midpoint to the next mean (+inf past the end), dmax at the
      // last nonempty slot; lb = the previous slot's ub, dmin at slot 0
      const float m_next = idx < kCap - 1 ? mrow[idx + 1] : inf;
      const float ub_at = idx == last ? rmax : (m_at + m_next) / 2.0f;
      float lb_at;
      if (idx == 0)
        lb_at = rmin;
      else if (idx - 1 == last)
        lb_at = rmax;
      else
        lb_at = (mrow[idx - 1] + m_at) / 2.0f;
      const float w_before = cw_at - w_at;
      const float proportion = (target - w_before) / max_tiny(w_at);
      float step = proportion * (ub_at - lb_at);
      step = (step == step) ? step : 0.0f;
      const float q = lb_at + step;
      orow[j] = live ? q : qnan;
    }
    __syncwarp();

    // the chunk's rows are one contiguous run of the output
    const int n = rows * ncol;
    float* dst = f.out + row0 * ncol;
    if (((row0 * ncol) & 3) == 0) {
      const int n4 = n >> 2;
      for (int t = lane; t < n4; t += 32)
        reinterpret_cast<float4*>(dst)[t] =
            reinterpret_cast<const float4*>(outs)[t];
      for (int t = 4 * n4 + lane; t < n; t += 32) dst[t] = outs[t];
    } else {
      for (int t = lane; t < n; t += 32) dst[t] = outs[t];
    }
    __syncwarp();
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Any P >= 1: the narrow kernel's row work (fetch, scalars, count, trees,
// scan) once per row, then the quantiles in blocks of kMaxP. Each block's
// columns stage in the warp's output rows (kMaxP + kAgg columns a row, the
// aggregates after the block) and leave as one run per row; the ten
// aggregate columns leave after the last block. The quantile arithmetic is
// the narrow kernel's, line for line. The narrow kernel keeps its own text:
// sharing one inlined body between the two changed ptxas's allocation of
// the narrow one (96 registers and 20 bytes of spills against 105 and 0).
template <int R>
__global__ void __launch_bounds__(kThreads)
    flush_extract_wide_kernel(const Fields f, int S, int P) {
  using C = Cfg<R>;
  constexpr int L = C::L, E = C::E, NS = C::NS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* base = smem + warp * C::kWarpBytes;
  float* stages = reinterpret_cast<float*>(base);
  float* cws = reinterpret_cast<float*>(base + NS * C::kStageBytes);
  float* outs = reinterpret_cast<float*>(base + NS * C::kStageBytes +
                                         C::kArrayBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      base + NS * C::kStageBytes + C::kArrayBytes + C::kOutBytes);

  const int g = lane & (R - 1);  // the chunk row this lane works on
  const int gl = lane / R;       // the lane's place within that row
  const long long nchunks = ((long long)S + R - 1) / R;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  const int ncol = P + kAgg;
  const float qnan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // bring chunk `chunk` into stage `stage` (warp-uniform call)
  auto fetch = [&](long long chunk, int stage) {
    if (chunk >= nchunks) return;
    const long long row0 = chunk * R;
    const int rows = (int)(S - row0 < R ? S - row0 : R);
    float* sm = stages + stage * (C::kStageBytes / 4);
    if (lane == 0) {
      // the warp's reads of this stage (ordered by the last __syncwarp)
      // come before the bulk copy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect(&bars[stage], (uint32_t)(rows * 2 * kRowBytes));
    }
    __syncwarp();
    if (lane < rows) {
      bulk_load(sm + lane * kRowStride, f.means + (row0 + lane) * kCap,
                kRowBytes, &bars[stage]);
      bulk_load(sm + (R + lane) * kRowStride,
                f.weights + (row0 + lane) * kCap, kRowBytes, &bars[stage]);
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) fetch(first + s * stride, s);

  int stage = 0;
  uint32_t phase = 0;
  for (long long chunk = first; chunk < nchunks; chunk += stride) {
    fetch(chunk + (NS - 1) * stride, stage == 0 ? NS - 1 : stage - 1);
    const long long row0 = chunk * R;
    const int rows = (int)(S - row0 < R ? S - row0 : R);
    const long long row = row0 + g;

    // the row's scalars, on its first lane (lane == g), before the wait
    float sc[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) sc[k] = 0.0f;
    if (gl == 0 && g < rows) {
      sc[0] = __ldg(f.dmin + row);
      sc[1] = __ldg(f.dmax + row);
      sc[2] = __ldg(f.drecip + row);
      sc[3] = __ldg(f.drecip_c + row);
      sc[4] = __ldg(f.lmin + row);
      sc[5] = __ldg(f.lmax + row);
      sc[6] = __ldg(f.lsum + row);
      sc[7] = __ldg(f.lsum_c + row);
      sc[8] = __ldg(f.lweight + row);
      sc[9] = __ldg(f.lweight_c + row);
      sc[10] = __ldg(f.lrecip + row);
      sc[11] = __ldg(f.lrecip_c + row);
    }

    mbar_wait(&bars[stage], phase);
    const float* mrow = stages + stage * (C::kStageBytes / 4) + g * kRowStride;
    const float* wrow = mrow + R * kRowStride;
    float* crow = cws + g * kRowStride;

    float w[E];
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(wrow + gl * E)[k];
      w[4 * k] = t.x;
      w[4 * k + 1] = t.y;
      w[4 * k + 2] = t.z;
      w[4 * k + 3] = t.w;
    }

    // number of nonempty slots, on every lane of the row
    int count = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) count += w[e] > 0.0f ? 1 : 0;
#pragma unroll
    for (int off = L / 2; off >= 1; off >>= 1)
      count += __shfl_xor_sync(kFull, count, off * R);

    // dsum and dcount: in-lane tree levels, then across the row's lanes;
    // the sums land on the row's first lane
    float vc = tree_sum<E>(w);
    float vs;
    {
      float pr[E];
#pragma unroll
      for (int k = 0; k < E / 4; ++k) {
        const float4 t = reinterpret_cast<const float4*>(mrow + gl * E)[k];
        const float m4[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wi = w[4 * k + i];
          pr[4 * k + i] = wi > 0.0f ? m4[i] * wi : 0.0f;
        }
      }
      vs = tree_sum<E>(pr);
    }
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
      vs = vs + __shfl_down_sync(kFull, vs, off * R);
      vc = vc + __shfl_down_sync(kFull, vc, off * R);
    }

    // cumulative weight, in place; then beside the row in shared memory
    hillis_steele<E, R>(w, gl);
    const float total = __shfl_sync(kFull, w[E - 1], g + (L - 1) * R);
#pragma unroll
    for (int k = 0; k < E / 4; ++k)
      reinterpret_cast<float4*>(crow + gl * E)[k] =
          make_float4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);

    const float rmin = __shfl_sync(kFull, sc[0], g);
    const float rmax = __shfl_sync(kFull, sc[1], g);
    // a staged row: one block of quantiles, then the aggregates at kMaxP
    constexpr int kWideCols = kMaxP + kAgg;
    constexpr int acol = kMaxP;
    float* orow = outs + g * kWideCols;
    if (gl == 0) {
      orow[acol + 0] = sc[0];
      orow[acol + 1] = sc[1];
      orow[acol + 2] = vs;
      orow[acol + 3] = vc;
      orow[acol + 4] = sc[2] + sc[3];
      orow[acol + 5] = sc[4];
      orow[acol + 6] = sc[5];
      orow[acol + 7] = sc[6] + sc[7];
      orow[acol + 8] = sc[8] + sc[9];
      orow[acol + 9] = sc[10] + sc[11];
    }
    __syncwarp();

    // quantile j of row g (the narrow kernel's arithmetic)
    const bool live = total > 0.0f && count > 0;
    const int last = count - 1;
    auto quantile = [&](int j) -> float {
      float target = __ldg(f.qs + j) * total;
      target = (target == target) ? target : 0.0f;
      int lo = 0, hi = kCap;
#pragma unroll
      for (int it = 0; it < 8; ++it) {  // 8 halvings empty [0, 128)
        if (lo < hi) {
          const int mid = lo + ((hi - lo) >> 1);
          if (!(crow[mid] >= target))
            lo = mid + 1;
          else
            hi = mid;
        }
      }
      const int idx = lo < kCap - 1 ? lo : kCap - 1;
      const float w_at = wrow[idx];
      const float cw_at = crow[idx];
      const float m_at = mrow[idx];
      // ub = midpoint to the next mean (+inf past the end), dmax at the
      // last nonempty slot; lb = the previous slot's ub, dmin at slot 0
      const float m_next = idx < kCap - 1 ? mrow[idx + 1] : inf;
      const float ub_at = idx == last ? rmax : (m_at + m_next) / 2.0f;
      float lb_at;
      if (idx == 0)
        lb_at = rmin;
      else if (idx - 1 == last)
        lb_at = rmax;
      else
        lb_at = (mrow[idx - 1] + m_at) / 2.0f;
      const float w_before = cw_at - w_at;
      const float proportion = (target - w_before) / max_tiny(w_at);
      float step = proportion * (ub_at - lb_at);
      step = (step == step) ? step : 0.0f;
      const float q = lb_at + step;
      return live ? q : qnan;
    };
    // blocks of kMaxP quantiles over the same row state; each block's
    // columns leave as one run per row
    for (int j0 = 0; j0 < P; j0 += kMaxP) {
      const int pb = P - j0 < kMaxP ? P - j0 : kMaxP;
      for (int j = gl; j < pb; j += L) orow[j] = quantile(j0 + j);
      __syncwarp();
      for (int t = lane; t < rows * pb; t += 32) {
        const int r = t / pb, c = t - r * pb;
        f.out[(row0 + r) * ncol + j0 + c] = outs[r * kWideCols + c];
      }
      __syncwarp();
    }
    for (int t = lane; t < rows * kAgg; t += 32) {
      const int r = t / kAgg, c = t - r * kAgg;
      f.out[(row0 + r) * ncol + P + c] = outs[r * kWideCols + kMaxP + c];
    }
    __syncwarp();
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }
}

using KernelFn = void (*)(const Fields, int, int);

template <int R, bool W>
KernelFn kernel_of() {
  if constexpr (W)
    return flush_extract_wide_kernel<R>;
  else
    return flush_extract_kernel<R>;
}

template <int R, bool W>
int occupancy() {
  const KernelFn k = kernel_of<R, W>();
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<R>::kBlockBytes);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                    Cfg<R>::kBlockBytes);
  return e == cudaSuccess ? blocks : -(int)e;
}

template <int R, bool W>
int launch(const void* const* fields, const void* qs, void* out, int S,
           int P, int grid, void* stream) {
  if (S <= 0) return 0;
  if (P < 1 || (!W && P > kMaxP) || grid < 1)
    return (int)cudaErrorInvalidValue;
  const KernelFn k = kernel_of<R, W>();
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<R>::kBlockBytes);
  if (e != cudaSuccess) return (int)e;
  const float* const* p = reinterpret_cast<const float* const*>(fields);
  const Fields f{p[0], p[1], p[2],  p[3],  p[4],  p[5],
                 p[6], p[7], p[8],  p[9],  p[10], p[11],
                 p[12], p[13], (const float*)qs, (float*)out};
  k<<<grid, kThreads, Cfg<R>::kBlockBytes, (cudaStream_t)stream>>>(f, S, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Per variant R (rows per warp), for the narrow kernel (P <= 16) and the
// wide one (any P): launch on `stream` (a cudaStream_t) and return
// cudaGetLastError(), so the caller sees a refused launch; the resident
// blocks per SM (negative: a CUDA error); the dynamic shared memory of one
// block (the same for both). `fields` holds the 14 state pointers in the
// column order above. The wrapper has checked shapes, types, contiguity,
// 16-byte alignment of means/weights, C == 128 and P >= 1.
#define FLUSH_EXTRACT_VARIANT(R)                                            \
  extern "C" int flush_extract_launch_r##R(                                 \
      const void* const* fields, const void* qs, void* out, int S, int P,   \
      int grid, void* stream) {                                             \
    return launch<R, false>(fields, qs, out, S, P, grid, stream);           \
  }                                                                         \
  extern "C" int flush_extract_launch_wide_r##R(                            \
      const void* const* fields, const void* qs, void* out, int S, int P,   \
      int grid, void* stream) {                                             \
    return launch<R, true>(fields, qs, out, S, P, grid, stream);            \
  }                                                                         \
  extern "C" int flush_extract_occupancy_r##R() {                           \
    return occupancy<R, false>();                                           \
  }                                                                         \
  extern "C" int flush_extract_occupancy_wide_r##R() {                      \
    return occupancy<R, true>();                                            \
  }                                                                         \
  extern "C" int flush_extract_smem_bytes_r##R() {                          \
    return Cfg<R>::kBlockBytes;                                             \
  }

FLUSH_EXTRACT_VARIANT(1)
FLUSH_EXTRACT_VARIANT(2)
FLUSH_EXTRACT_VARIANT(4)
FLUSH_EXTRACT_VARIANT(8)

extern "C" int flush_extract_threads_per_block() { return kThreads; }
