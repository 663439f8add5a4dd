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
// Bit contract: the XLA path's, not the Pallas kernel's (which takes its
// cumsum as a triangular matmul and is only close to it). So:
//   * cumulative weight is the Hillis-Steele scan of ops/exactnum.cumsum,
//     x[i] + x[i - s] for s = 1, 2, 4, ..., 64, the lanes i < s adding 0.0f;
//   * dsum and dcount are the adjacent-pair halving tree of exactnum.tsum;
//   * target = qs[j] * total is rounded to f32 (exactnum.block: NaN -> 0);
//   * the slot is searchsorted(w_cum, target, side="left"), clamped to
//     C - 1: w_cum is nondecreasing (non-negative weights, monotone
//     rounding), so that is the count of slots with w_cum < target;
//   * proportion = (target - w_before) / max(w_at, 1e-30f),
//     out = lb + round(proportion * (ub - lb)), NaN where
//     !(total > 0 && count > 0).
// Built with -fmad=false and without fast math, so no product is fused
// into an add and f32 division is correctly rounded.
//
// Design: one warp per digest row, each lane holding 4 contiguous
// centroids (C = 128 = 32 lanes x float4, one 16-byte load per lane for
// means and one for weights). Scan steps use __shfl_up_sync, the sum tree
// __shfl_down_sync, the slot choice __ballot_sync + __popc, and the
// gathers at the chosen slot __shfl_sync. Warps stride over rows on a grid
// sized to the SMs; a warp past the last row does no work, which masks
// the ragged edge.
//
// Bound: memory. Per row it reads 2 x 128 x 4 B of centroids plus 12
// scalars and writes P + 10 floats; at S = 1,048,576 and P = 3 that is
// about 1.18 GB, 0.35 ms at the H100's 3.35 TB/s. The arithmetic (a few
// hundred flops per row) is far below the card's rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCap = 128;  // centroids per row
constexpr int kMaxP = 16;  // quantiles per call (the wrapper checks)
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pick4(const float (&v)[4], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : (k == 2 ? v[2] : v[3]));
}

// jnp.maximum(x, 1e-30): NaN propagates
__device__ __forceinline__ float max_tiny(float x) {
  const float tiny = 1e-30f;
  return (x != x) ? x : (x < tiny ? tiny : x);
}

__global__ void __launch_bounds__(kThreads) flush_extract_kernel(
    const float* __restrict__ means, const float* __restrict__ weights,
    const float* __restrict__ dmin, const float* __restrict__ dmax,
    const float* __restrict__ drecip, const float* __restrict__ drecip_c,
    const float* __restrict__ lmin, const float* __restrict__ lmax,
    const float* __restrict__ lsum, const float* __restrict__ lsum_c,
    const float* __restrict__ lweight, const float* __restrict__ lweight_c,
    const float* __restrict__ lrecip, const float* __restrict__ lrecip_c,
    const float* __restrict__ qs, float* __restrict__ out, int S, int P) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_block = blockDim.x >> 5;
  const long long first = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * warps_per_block;
  const int ncol = P + 10;
  const float qnan = __int_as_float(0x7fc00000);

  for (long long row = first; row < S; row += stride) {
    const float4 m4 =
        reinterpret_cast<const float4*>(means + row * kCap)[lane];
    const float4 w4 =
        reinterpret_cast<const float4*>(weights + row * kCap)[lane];
    const float m[4] = {m4.x, m4.y, m4.z, m4.w};
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
    const float row_min = dmin[row];
    const float row_max = dmax[row];

    // number of nonempty slots
    int count = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) count += __popc(__ballot_sync(kFull, w[k] > 0.0f));

    // cumulative weight: Hillis-Steele over the row's 128 lanes
    float cw[4] = {w[0], w[1], w[2], w[3]};
    {  // shift 1
      const float up3 = __shfl_up_sync(kFull, cw[3], 1);
      const float p0 = lane >= 1 ? up3 : 0.0f;
      const float n0 = cw[0] + p0, n1 = cw[1] + cw[0];
      const float n2 = cw[2] + cw[1], n3 = cw[3] + cw[2];
      cw[0] = n0; cw[1] = n1; cw[2] = n2; cw[3] = n3;
    }
    {  // shift 2
      const float up2 = __shfl_up_sync(kFull, cw[2], 1);
      const float up3 = __shfl_up_sync(kFull, cw[3], 1);
      const float p0 = lane >= 1 ? up2 : 0.0f;
      const float p1 = lane >= 1 ? up3 : 0.0f;
      const float n0 = cw[0] + p0, n1 = cw[1] + p1;
      const float n2 = cw[2] + cw[0], n3 = cw[3] + cw[1];
      cw[0] = n0; cw[1] = n1; cw[2] = n2; cw[3] = n3;
    }
#pragma unroll
    for (int lanes = 1; lanes < 32; lanes <<= 1) {  // shifts 4 .. 64
      float p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float up = __shfl_up_sync(kFull, cw[k], lanes);
        p[k] = lane >= lanes ? up : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) cw[k] = cw[k] + p[k];
    }
    const float total = __shfl_sync(kFull, cw[3], 31);

    // dsum and dcount: adjacent-pair halving trees
    float vs = (((w[0] > 0.0f) ? m[0] * w[0] : 0.0f) +
                ((w[1] > 0.0f) ? m[1] * w[1] : 0.0f)) +
               (((w[2] > 0.0f) ? m[2] * w[2] : 0.0f) +
                ((w[3] > 0.0f) ? m[3] * w[3] : 0.0f));
    float vc = (w[0] + w[1]) + (w[2] + w[3]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      vs = vs + __shfl_down_sync(kFull, vs, off);
      vc = vc + __shfl_down_sync(kFull, vc, off);
    }
    const float dsum = __shfl_sync(kFull, vs, 0);
    const float dcount = __shfl_sync(kFull, vc, 0);

    // slot bounds: ub = midpoint to the next mean (+inf past the end),
    // dmax at the last nonempty slot; lb = previous ub, dmin at slot 0
    const float next0 = __shfl_down_sync(kFull, m[0], 1);
    const float nm[4] = {m[1], m[2], m[3],
                         lane == 31 ? __int_as_float(0x7f800000) : next0};
    float ub[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float mid = (m[k] + nm[k]) / 2.0f;
      ub[k] = (4 * lane + k == count - 1) ? row_max : mid;
    }
    const float ub_prev = __shfl_up_sync(kFull, ub[3], 1);
    const float lb[4] = {lane == 0 ? row_min : ub_prev, ub[0], ub[1], ub[2]};

    const bool live = total > 0.0f && count > 0;
    float mine = 0.0f;
    for (int j = 0; j < P; ++j) {
      float target = qs[j] * total;
      target = (target == target) ? target : 0.0f;
      int idx = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        idx += __popc(__ballot_sync(kFull, cw[k] < target));
      idx = idx < kCap - 1 ? idx : kCap - 1;
      const int src = idx >> 2, kk = idx & 3;
      const float w_at = __shfl_sync(kFull, pick4(w, kk), src);
      const float cw_at = __shfl_sync(kFull, pick4(cw, kk), src);
      const float lb_at = __shfl_sync(kFull, pick4(lb, kk), src);
      const float ub_at = __shfl_sync(kFull, pick4(ub, kk), src);
      const float w_before = cw_at - w_at;
      const float proportion = (target - w_before) / max_tiny(w_at);
      float step = proportion * (ub_at - lb_at);
      step = (step == step) ? step : 0.0f;
      const float q = lb_at + step;
      if (lane == j) mine = live ? q : qnan;
    }

    if (lane < ncol) {
      float v = mine;
      switch (lane - P) {
        case 0: v = row_min; break;
        case 1: v = row_max; break;
        case 2: v = dsum; break;
        case 3: v = dcount; break;
        case 4: v = drecip[row] + drecip_c[row]; break;
        case 5: v = lmin[row]; break;
        case 6: v = lmax[row]; break;
        case 7: v = lsum[row] + lsum_c[row]; break;
        case 8: v = lweight[row] + lweight_c[row]; break;
        case 9: v = lrecip[row] + lrecip_c[row]; break;
        default: break;
      }
      out[row * ncol + lane] = v;
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() so the
// caller sees a refused launch. The wrapper has checked shapes, types,
// contiguity, 16-byte alignment of means/weights, C == 128 and P <= 16.
extern "C" int flush_extract_launch(
    const void* means, const void* weights, const void* dmin,
    const void* dmax, const void* drecip, const void* drecip_c,
    const void* lmin, const void* lmax, const void* lsum, const void* lsum_c,
    const void* lweight, const void* lweight_c, const void* lrecip,
    const void* lrecip_c, const void* qs, void* out, int S, int P, int grid,
    void* stream) {
  if (S <= 0) return 0;
  if (P < 1 || P > kMaxP || grid < 1) return (int)cudaErrorInvalidValue;
  flush_extract_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)means, (const float*)weights, (const float*)dmin,
      (const float*)dmax, (const float*)drecip, (const float*)drecip_c,
      (const float*)lmin, (const float*)lmax, (const float*)lsum,
      (const float*)lsum_c, (const float*)lweight, (const float*)lweight_c,
      (const float*)lrecip, (const float*)lrecip_c, (const float*)qs,
      (float*)out, S, P);
  return (int)cudaGetLastError();
}

extern "C" int flush_extract_threads_per_block() { return kThreads; }
