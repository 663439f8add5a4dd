// t-digest fold kernels for Hopper (sm_90a): K2a, the per-row compression
// of candidate centroid rows [S, M] -> [S, C], and K2b, the spill fold of
// a raw-sample batch into digest rows (add_batch).
//
// K2a replaces veneur_tpu/ops/tdigest.py _compress_rows (:142-197), K2b
// replaces add_batch (:224-353) after its sort; both are jitted XLA
// programs there, not Pallas kernels, and ops/tdigest.py of the port keeps
// their plain PyTorch versions (_compress_rows_plain, add_batch_plain).
// The contract is bitwise: every output equals the plain version's on the
// same inputs, on the card, which equals the reference's on the CPU.
//
// K2a, one block a row (td_compress_kernel). The row lives in shared
// memory (dynamic, past 48 KB where M needs it; past what a block can
// hold, in a global scratch slab a row, same code). Per row, the
// reference's steps:
//   1. zero-weight slots keyed +inf; a stable sort by mean, the weights
//      carried (a bitonic network on the 64-bit key (order key, slot),
//      unique keys, so the network's order is the stable one);
//   2. a Hillis-Steele inclusive scan of the weights over the M slots;
//   3. q_left = (w_cum - w) / max(total, 1e-30);
//   4. the bucket: searchsorted(right) over the f32 table of the floor(d)
//      k1 boundaries (exactnum.kscale_boundaries), clipped to C - 1;
//   5. the flushed Hillis scan of mean * w;
//   6. at each run end (bucket != next bucket, the row end included) the
//      run's sums as differences against the previous run end
//      (segments.last_marked_carry: a select, so the index of the previous
//      end from a max scan reads the same value), the run's mean a
//      division;
//   7. a second stable sort by mean; the first C slots are the row.
// Bound: bytes, S * M * 8 read and S * C * 8 written (1.5 us a thousand
// rows at M = 192 on 3.35 TB/s). The per-row work is two sorts of the
// next power of two P >= M (P log2 P (log2 P + 1) / 4 compare-exchanges
// each) and three log2 M scans, each step a block barrier; many small
// blocks (P / 2 threads up to 256) keep the SMs full while they wait.
//
// K2b, the spill fold (td_add_batch_launch): the batch arrives sorted by
// (row, value), the wrapper's two stable torch.sort calls, padding
// samples keyed past the last row. Launches, all of this source:
//   td_scan_tile: per tile of 512 samples, the three N-long Hillis scans of
//     the reference's _prefix_scans (w; the flushed v*w, NaN blocked to 0;
//     the flushed w/v where w > 0) over their shifts below 512, from a
//     512-sample halo before the tile; and per 128-sample chunk the
//     in-chunk segmented Hillis scans of segments.segmented_cumsum,
//     forward over the row starts and backward (the flipped array) over
//     the row ends, with each chunk's carry and its first start;
//   td_scan_step (log2 N - 7 launches): the N-long scans' shifts from 512
//     on, and the cross-chunk segmented Hillis carry of both directions;
//   td_add_rows: one block a digest row: the row bounds (searchsorted),
//     the batch stats (prefix-sum differences, min and max as gathers of
//     the raw values), each sample's bucket from its segmented sums, the
//     row's run table, the [C] batch digest, then K2a's routine over the
//     [2C] candidates (the row and the batch digest) in shared memory, and
//     the digest scalars.
// Bound: bytes, the batch's N * 12 (row, value, weight) read, the
// [K, C] rows read and written and the scalars (the sort before it is
// timed apart). The N-long scans cost 3 * N * 8 bytes a pass over 9 to 11
// passes: launches, not bytes, at these sizes.
//
// Where the bits would differ unless the kernel does as the plain version
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
//   * min and max. torch.minimum / maximum on the CPU keep the first
//     operand on a tie (-0.0 against +0.0) and propagate a NaN operand;
//     tmin / tmax do the same, and the plain version writes them out as
//     selects so the card's plain version agrees.
//   * NaN in clamp_min and searchsorted: clamp_min keeps a NaN; a NaN
//     quantile lands past the table (torch's upper-bound loop).
//
// The kernels are written with block-strided loops between barriers and
// no warp intrinsics, so the same source runs with one thread a block:
// tests/test_torch_tdigest_kernel.py builds it with g++ (TD_EMULATE, its
// own TD_LAUNCH running the blocks in turn with flush to zero and
// denormals-are-zero set in MXCSR) and holds it, launchers included, to
// the plain version on the CPU.

#ifndef TD_EMULATE
#include <cuda_runtime.h>
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

constexpr int kChunk = 128;     // segments.CHUNK
constexpr int kTile = 512;      // K2b's in-block scan tile (and its halo)
constexpr int kRunTile = 256;   // samples a pass of the run table
constexpr float kTiny = 1e-30f;
// a block's dynamic shared memory (227 KB); rows that need more take a
// global scratch slab
constexpr size_t kMaxSmem = 232448;

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

// torch.minimum / maximum on the CPU: a NaN operand wins (the first's
// first), a tie keeps the first operand
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
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

// one row's buffers: n candidates, p = pow2 >= n sort lanes
struct RowBufs {
  uint64_t* key;          // [p]
  float* sm;              // [n] sorted means, then the run means
  float* sw;              // [n] sorted weights, then the run weights
  float* x0; float* y0;   // [n] scan buffers (w, m*w)
  float* x1; float* y1;   // [n] the candidates' means and weights on
                          //     entry, then scan buffers
  int* b;                 // [n] buckets
  int* e0; int* e1;       // [n] the run-end max scan
};

__host__ __device__ __forceinline__ size_t row_bytes(int n, int p) {
  return align16(8ull * p) + 9 * align16(4ull * n);
}

__device__ __forceinline__ RowBufs carve(unsigned char* base, int n, int p) {
  RowBufs r;
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

// ascending bitonic sort of p (a power of two) unique 64-bit keys; the
// caller has synchronised after writing them
__device__ void bitonic_sort(uint64_t* s, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (p >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i | j;
        const uint64_t x = s[i], y = s[l];
        const bool up = (i & k) == 0;
        if ((x > y) == up) {
          s[i] = y;
          s[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

// the compression of one row of n candidates (means in r.x1, weights in
// r.y1, the raw inputs) into c slots at out_m / out_w; the caller has
// synchronised after writing the candidates
__device__ void compress_row(const RowBufs& r, int n, int p, int c,
                             const float* tbl, int tlen, float* out_m,
                             float* out_w) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float inf = f_inf();
  // 1. flushed weights; zero-weight slots keyed +inf (in place)
  for (int i = tid; i < p; i += nt) {
    if (i < n) {
      const float w = flush(r.y1[i]);
      const float key = w > 0.0f ? flush(r.x1[i]) : inf;
      r.x1[i] = key;
      r.y1[i] = w;
      r.key[i] = ((uint64_t)order_key(key) << 32) | (uint32_t)i;
    } else {
      r.key[i] = ~0ull;
    }
  }
  __syncthreads();
  bitonic_sort(r.key, p);
  for (int i = tid; i < n; i += nt) {
    const uint32_t src = (uint32_t)r.key[i];
    r.sm[i] = r.x1[src];
    r.sw[i] = r.y1[src];
  }
  __syncthreads();
  // 2 and 5. the weight scan and the flushed scan of mean * weight
  for (int i = tid; i < n; i += nt) {
    const float w = r.sw[i];
    r.x0[i] = w;
    r.y0[i] = w > 0.0f ? flush(r.sm[i] * w) : 0.0f;
  }
  __syncthreads();
  float *xa = r.x0, *ya = r.y0, *xb = r.x1, *yb = r.y1;
  for (int s = 1; s < n; s <<= 1) {
    for (int i = tid; i < n; i += nt) {
      const float xs = i >= s ? xa[i - s] : 0.0f;
      const float ys = i >= s ? ya[i - s] : 0.0f;
      xb[i] = xa[i] + xs;
      yb[i] = flush(ya[i] + ys);
    }
    __syncthreads();
    float* t = xa; xa = xb; xb = t;
    t = ya; ya = yb; yb = t;
  }
  const float* wc = xa;   // w_cum
  const float* mwc = ya;  // mw_cum
  // 3 and 4. left-edge quantile and bucket
  const float total = clamp_tiny(wc[n - 1]);
  for (int i = tid; i < n; i += nt) {
    const float q = flush(flush(wc[i] - r.sw[i]) / total);
    const int b = upper_bound(tbl, tlen, q);
    r.b[i] = b < c - 1 ? b : c - 1;
  }
  __syncthreads();
  // 6. run ends, and the previous run end of each (a max scan)
  for (int i = tid; i < n; i += nt)
    r.e0[i] = (i == n - 1 || r.b[i] != r.b[i + 1]) ? i : -1;
  __syncthreads();
  int *ea = r.e0, *eb = r.e1;
  for (int s = 1; s < n; s <<= 1) {
    for (int i = tid; i < n; i += nt) {
      const int v = ea[i], u = i >= s ? ea[i - s] : -1;
      eb[i] = v > u ? v : u;
    }
    __syncthreads();
    int* t = ea; ea = eb; eb = t;
  }
  for (int i = tid; i < p; i += nt) {
    if (i < n) {
      float nm = inf, nw = 0.0f;
      if (i == n - 1 || r.b[i] != r.b[i + 1]) {
        const int j = i > 0 ? ea[i - 1] : -1;
        const float wb = j >= 0 ? wc[j] : 0.0f;
        const float mwb = j >= 0 ? mwc[j] : 0.0f;
        const float seg_w = flush(wc[i] - wb);
        const float seg_mw = flush(mwc[i] - mwb);
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
  __syncthreads();
  // 7. sort by mean, keep the first c
  bitonic_sort(r.key, p);
  for (int i = tid; i < c; i += nt) {
    const uint32_t src = (uint32_t)r.key[i];
    out_m[i] = r.sm[src];
    out_w[i] = r.sw[src];
  }
}

__global__ void td_compress_kernel(const float* __restrict__ means,
                                   const float* __restrict__ weights,
                                   int m, int c, const float* tbl, int tlen,
                                   unsigned char* scratch,
                                   float* __restrict__ out_m,
                                   float* __restrict__ out_w) {
  TD_DYNAMIC_SMEM(smem);
  const long long row = blockIdx.x;
  const int p = pow2_at_least(m);
  unsigned char* base =
      scratch ? scratch + (size_t)row * row_bytes(m, p) : smem;
  const RowBufs r = carve(base, m, p);
  const float* gm = means + row * m;
  const float* gw = weights + row * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    r.x1[i] = gm[i];
    r.y1[i] = gw[i];
  }
  __syncthreads();
  compress_row(r, m, p, c, tbl, tlen, out_m + row * c, out_w + row * c);
}

// ---------------------------------------------------------------------------
// K2b

struct ScanBufs {
  // the three N-long prefix scans (w, v*w, w/v), before any shift >= 512
  float* pw; float* pvw; float* prc;
  // the in-chunk segmented scans, forward and backward (flipped), [g*128]
  float* svf; float* svb;
  // per chunk: last column, any-start flag, first start lane
  float* cvf; int* cff; int* fsf;
  float* cvb; int* cfb; int* fsb;
};

__global__ void td_scan_tile(const long long* __restrict__ srows,
                             const float* __restrict__ svals,
                             const float* __restrict__ sw, int n, int g,
                             ScanBufs o) {
  __shared__ float xw[2][2 * kTile], xv[2][2 * kTile], xr[2][2 * kTile];
  __shared__ float cv[2][2][kTile];
  __shared__ unsigned char cf[2][2][kTile];
  __shared__ int first[2][kTile / kChunk];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long t0 = (long long)blockIdx.x * kTile;
  // the N-long scans over this tile, from a kTile-sample halo before it
  // (positions before 0 hold +0.0, the pad lanes' addend)
  for (int j = tid; j < 2 * kTile; j += nt) {
    const long long q = t0 - kTile + j;
    float w = 0.0f, vw = 0.0f, rc = 0.0f;
    if (q >= 0 && q < n) {
      w = sw[q];
      const float v = svals[q];
      const float prod = flush(v * w);
      vw = prod == prod ? prod : 0.0f;  // exactnum.block
      rc = w > 0.0f ? flush(w / v) : 0.0f;
    }
    xw[0][j] = w;
    xv[0][j] = vw;
    xr[0][j] = rc;
  }
  // the chunks of this tile, forward and backward: value, start flag
  for (int j = tid; j < 2 * (kTile / kChunk); j += nt)
    first[j / (kTile / kChunk)][j % (kTile / kChunk)] = kChunk;
  __syncthreads();
  for (int j = tid; j < kTile; j += nt) {
    const long long q = t0 + j;
    const int lane = j & (kChunk - 1);
    float vf = 0.0f, vb = 0.0f;
    bool sf = false, sb = false;
    if (q < n) {
      vf = sw[q];
      sf = q == 0 || srows[q] != srows[q - 1];
      const long long i = n - 1 - q;  // the flipped array's element q
      vb = sw[i];
      sb = q == 0 || srows[i + 1] != srows[i];
    } else if (q == 0) {
      sf = sb = true;
    }
    cv[0][0][j] = vf;
    cv[1][0][j] = vb;
    cf[0][0][j] = sf || lane == 0;
    cf[1][0][j] = sb || lane == 0;
    if (sf) atomicMin(&first[0][j / kChunk], lane);
    if (sb) atomicMin(&first[1][j / kChunk], lane);
  }
  __syncthreads();
  int a = 0;
  for (int s = 1; s < kTile && s < n; s <<= 1) {
    for (int j = tid; j < 2 * kTile; j += nt) {
      const bool in = j >= s;
      xw[a ^ 1][j] = xw[a][j] + (in ? xw[a][j - s] : 0.0f);
      xv[a ^ 1][j] = flush(xv[a][j] + (in ? xv[a][j - s] : 0.0f));
      xr[a ^ 1][j] = flush(xr[a][j] + (in ? xr[a][j - s] : 0.0f));
    }
    __syncthreads();
    a ^= 1;
  }
  for (int j = tid; j < kTile; j += nt) {
    const long long q = t0 + j;
    if (q < n) {
      o.pw[q] = xw[a][kTile + j];
      o.pvw[q] = xv[a][kTile + j];
      o.prc[q] = xr[a][kTile + j];
    }
  }
  // the in-chunk segmented scans: v = f ? v : v + v[-s]; f |= f[-s]
  // (lanes below the shift: v + 0.0, f | true)
  int bsel = 0;
  for (int s = 1; s < kChunk; s <<= 1) {
    for (int j = tid; j < kTile; j += nt) {
      const bool in = (j & (kChunk - 1)) >= s;
      for (int d = 0; d < 2; ++d) {
        const float v = cv[d][bsel][j];
        const bool f = cf[d][bsel][j];
        const float vs = in ? cv[d][bsel][j - s] : 0.0f;
        const bool fs = in ? cf[d][bsel][j - s] : true;
        cv[d][bsel ^ 1][j] = f ? v : v + vs;
        cf[d][bsel ^ 1][j] = f || fs;
      }
    }
    __syncthreads();
    bsel ^= 1;
  }
  const long long padded = (long long)g * kChunk;
  for (int j = tid; j < kTile; j += nt) {
    const long long q = t0 + j;
    if (q >= padded) continue;
    o.svf[q] = cv[0][bsel][j];
    o.svb[q] = cv[1][bsel][j];
    if ((j & (kChunk - 1)) == kChunk - 1) {
      const long long ch = q / kChunk;
      const int lc = j / kChunk;
      o.cvf[ch] = cv[0][bsel][j];
      o.cvb[ch] = cv[1][bsel][j];
      o.fsf[ch] = first[0][lc];
      o.fsb[ch] = first[1][lc];
      // a chunk holding a real start (chunk 0 always: its first element)
      o.cff[ch] = first[0][lc] < kChunk;
      o.cfb[ch] = first[1][lc] < kChunk;
    }
  }
}

// one shift of the N-long scans (sn > 0) and of both cross-chunk carry
// scans (sg > 0), from the in buffers to the out buffers
__global__ void td_scan_step(int n, int sn, const float* iw, const float* iv,
                             const float* ir, float* ow, float* ov, float* orc,
                             int g, int sg, const float* icf, const int* iff,
                             const float* icb, const int* ifb, float* ocf,
                             int* off, float* ocb, int* ofb) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long hi = n > g ? n : g;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < hi; i += stride) {
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

__device__ __forceinline__ long long upper_bound_rows(const long long* a,
                                                      long long n,
                                                      long long v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (!(a[mid] > v)) lo = mid + 1;
    else hi = mid;
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

__device__ __forceinline__ int sample_bucket(const RowsArgs& a, long long q) {
  const float seg = seg_at(a.svf, a.cvf, a.fsf, q);
  const float suf = seg_at(a.svb, a.cvb, a.fsb, a.n - 1 - q);
  const float w = a.sw[q];
  const float row_total = flush(flush(seg + suf) - w);
  const float ql = flush(flush(seg - w) / clamp_tiny(row_total));
  const int b = upper_bound(a.tbl, a.tlen, ql);
  return b < a.c - 1 ? b : a.c - 1;
}

__global__ void td_add_rows(RowsArgs a) {
  TD_DYNAMIC_SMEM(smem);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = a.c, m = 2 * c, p = pow2_at_least(m);
  const long long row = blockIdx.x;
  const float inf = f_inf();
  const RowBufs r = carve(smem, m, p);
  unsigned char* tail = smem + row_bytes(m, p);
  int* bt = reinterpret_cast<int*>(tail);          // [kRunTile]
  int* fl0 = bt + kRunTile;                        // [kRunTile]
  int* fl1 = fl0 + kRunTile;                       // [kRunTile]
  long long* rstart = reinterpret_cast<long long*>(fl1 + kRunTile);  // [c]
  long long* bounds = rstart + c;                  // lo, hi
  int* runs = reinterpret_cast<int*>(bounds + 2);  // count, last bucket
  if (tid == 0) {
    bounds[1] = upper_bound_rows(a.srows, a.n, row);
    bounds[0] = row == 0 ? 0 : upper_bound_rows(a.srows, a.n, row - 1);
    runs[0] = 0;
    runs[1] = -1;
  }
  __syncthreads();
  const long long lo = bounds[0], hi = bounds[1];
  const float seg_w = flush(pre(a.pw, hi) - pre(a.pw, lo));
  const bool has = seg_w > 0.0f;
  // the row's runs: a start where the bucket changes (the row's first
  // sample always); the first c starts kept
  for (long long base = lo; has && base < hi; base += kRunTile) {
    const long long cnt = hi - base < kRunTile ? hi - base : kRunTile;
    for (int j = tid; j < kRunTile; j += nt)
      bt[j] = j < cnt ? sample_bucket(a, base + j) : -1;
    __syncthreads();
    for (int j = tid; j < kRunTile; j += nt) {
      const int prev = j > 0 ? bt[j - 1] : runs[1];
      fl0[j] = j < cnt && (base + j == lo || bt[j] != prev);
    }
    __syncthreads();
    int *fa = fl0, *fb = fl1;
    for (int s = 1; s < kRunTile; s <<= 1) {
      for (int j = tid; j < kRunTile; j += nt)
        fb[j] = fa[j] + (j >= s ? fa[j - s] : 0);
      __syncthreads();
      int* t = fa; fa = fb; fb = t;
    }
    const int before = runs[0];
    for (int j = tid; j < cnt; j += nt) {
      const bool start = base + j == lo || bt[j] != (j > 0 ? bt[j - 1]
                                                          : runs[1]);
      const int rr = before + fa[j] - 1;
      if (start && rr < c) rstart[rr] = base + j;
    }
    __syncthreads();
    if (tid == 0) {
      runs[0] = before + fa[kRunTile - 1];
      runs[1] = bt[cnt - 1];
    }
    __syncthreads();
  }
  const int nr = has ? runs[0] : 0;
  // the batch digest [c] beside the row's centroids: the 2c candidates
  const long long off = row * c;
  for (int j = tid; j < c; j += nt) {
    r.x1[j] = a.means[off + j];
    r.y1[j] = a.weights[off + j];
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
    r.x1[c + j] = bw > 0.0f ? flush(bmw / clamp_tiny(bw)) : inf;
    r.y1[c + j] = bw;
  }
  if (tid == 0) {
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
    a.out_min[row] = tmin(flush(a.dmin[row]), flush(seg_min));
    a.out_max[row] = tmax(flush(a.dmax[row]), flush(seg_max));
    a.out_recip[row] = flush(flush(a.drecip[row]) + seg_recip);
  }
  __syncthreads();
  compress_row(r, m, p, c, a.tbl, a.tlen, a.out_m + off, a.out_w + off);
}

size_t add_rows_smem(int c) {
  const int m = 2 * c, p = pow2_at_least(m);
  return row_bytes(m, p) + 3 * 4 * kRunTile + 8 * (size_t)(c + 2) + 8;
}

int compress_threads(int p) { return p >= 512 ? 256 : (p >= 64 ? p / 2 : 32); }

}  // namespace

extern "C" {

// the bytes of one row's buffers, and whether they fit a block's shared
// memory (else the launcher takes a global scratch slab of s of them)
long long td_compress_row_bytes(int m) {
  return (long long)row_bytes(m, pow2_at_least(m));
}

int td_compress_smem_limit() { return (int)kMaxSmem; }

int td_compress_launch(const float* means, const float* weights, long long s,
                       int m, int c, const float* tbl, int tlen,
                       unsigned char* scratch, float* out_m, float* out_w,
                       void* stream) {
  const int p = pow2_at_least(m);
  const size_t smem = scratch ? 0 : row_bytes(m, p);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        td_compress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  TD_LAUNCH(td_compress_kernel, (unsigned)s, compress_threads(p), smem,
            (cudaStream_t)stream, means, weights, m, c, tbl, tlen, scratch,
            out_m, out_w);
  return (int)cudaGetLastError();
}

// scratch: 6n floats (two buffers of each N-long scan), 2 * g * 128
// floats (the chunk scans), 4g floats and 6g ints (the carries, two
// buffers each, and the first starts)
int td_add_batch_launch(const float* means, const float* weights,
                        const float* dmin, const float* dmax,
                        const float* drecip, int k, int c,
                        const long long* srows, const float* svals,
                        const float* sw, const float* raw, int n,
                        const float* tbl, int tlen, float* fscratch,
                        int* iscratch, float* out_m, float* out_w,
                        float* out_min, float* out_max, float* out_recip,
                        float* st_w, float* st_min, float* st_max,
                        float* st_sum, float* st_recip, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int g = (n + kChunk - 1) / kChunk;
  float* scan[2][3] = {{fscratch, fscratch + n, fscratch + 2 * (size_t)n},
                       {fscratch + 3 * (size_t)n, fscratch + 4 * (size_t)n,
                        fscratch + 5 * (size_t)n}};
  float* fc = fscratch + 6 * (size_t)n;
  float* svf = fc;
  float* svb = fc + (size_t)g * kChunk;
  float* cvf[2] = {svb + (size_t)g * kChunk, svb + (size_t)g * kChunk + g};
  float* cvb[2] = {cvf[1] + g, cvf[1] + 2 * g};
  int* cff[2] = {iscratch, iscratch + g};
  int* cfb[2] = {iscratch + 2 * g, iscratch + 3 * g};
  int* fsf = iscratch + 4 * g;
  int* fsb = iscratch + 5 * g;
  ScanBufs o{scan[0][0], scan[0][1], scan[0][2], svf, svb,
             cvf[0], cff[0], fsf, cvb[0], cfb[0], fsb};
  const int tiles = (n + kTile - 1) / kTile;
  TD_LAUNCH(td_scan_tile, tiles, kTile, 0, st, srows, svals, sw, n, g, o);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int an = 0, ag = 0;  // which buffer holds each scan
  for (int sn = kTile, sg = 1; sn < n || sg < g; sn <<= 1, sg <<= 1) {
    const int dn = sn < n ? sn : 0, dg = sg < g ? sg : 0;
    const long long work = n > g ? n : g;
    const int blocks = (int)((work + 255) / 256 < 65535 ? (work + 255) / 256
                                                        : 65535);
    TD_LAUNCH(td_scan_step, blocks, 256, 0, st,
        n, dn, scan[an][0], scan[an][1], scan[an][2], scan[an ^ 1][0],
        scan[an ^ 1][1], scan[an ^ 1][2], g, dg, cvf[ag], cff[ag], cvb[ag],
        cfb[ag], cvf[ag ^ 1], cff[ag ^ 1], cvb[ag ^ 1], cfb[ag ^ 1]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (dn) an ^= 1;
    if (dg) ag ^= 1;
  }
  RowsArgs a{means, weights, dmin, dmax, drecip, k, c, srows, sw, raw, n,
             scan[an][0], scan[an][1], scan[an][2], svf, cvf[ag], fsf,
             svb, cvb[ag], fsb, tbl, tlen, out_m, out_w, out_min, out_max,
             out_recip, st_w, st_min, st_max, st_sum, st_recip};
  const size_t smem = add_rows_smem(c);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(td_add_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  TD_LAUNCH(td_add_rows, k, compress_threads(pow2_at_least(2 * c)), smem, st,
            a);
  return (int)cudaGetLastError();
}

}  // extern "C"
