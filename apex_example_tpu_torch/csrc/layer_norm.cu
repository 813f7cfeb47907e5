// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces apex_example_tpu/ops/layer_norm.py:66 `_fwd_kernel` (the Pallas
// kernel launched by `_norm_fwd_pallas`, :126 / :144).  Same arithmetic:
// per row, the fp32 mean, then the fp32 variance of the centred row (two
// passes, not Welford), rstd = rsqrt(var + eps) with eps 1e-5 by default,
// y = (x - mean) * rstd * gamma + beta written in x's dtype, and mean and
// rstd written as fp32.  gamma and beta are fp32.  x is fp32, bf16 or fp16.
//
// Bound: bytes.  One call must move N*H*(in + out bytes) + 2*H*4 (gamma,
// beta) + 8*N (mean, rstd) and does about eight operations per element, so
// its least time is the bytes over the card's 3.35 TB/s.  At the serving
// shape (128 x 768, fp32) that is ~0.79 MB, ~0.24 us: there the launch's
// fixed cost, not the memory, sets the time.  What the design does about
// the bytes: one pass over device memory.  Each row is loaded once into
// registers, both reductions and the normalisation read the registers, and
// nothing but y, mean and rstd is stored.
//
// Packs.  VEC neighbouring elements move as one load or store: the widest
// power of two up to 16 bytes that divides H and keeps x, y, gamma and
// beta aligned (`vec_width`).  So H = 410 (transformer_xl) takes 8-byte
// fp32 pairs and 4-byte bf16 pairs, an odd H or a pointer off alignment
// single elements.  gamma and beta are read in packs of up to 4 floats.
//
// Layout: a row group of TPR threads owns one row.  Every row of up to
// 1024 elements, whatever VEC, takes one warp (TPR = 32, four rows in a
// 128-thread block): at most 32 floats a lane, warp shuffles alone, no
// __syncthreads; bf16 and fp16 rows in 16-byte packs keep the warp up to
// 2048 elements (64 floats a lane).  Wider rows, up to kMaxH, take a
// 512-thread block each and reduce across its warps through shared
// memory.  A lane issues all its loads of the row before it uses one.
//
// RMSNorm forward: the same kernel with kMean = false.  Replaces
// apex_example_tpu/ops/layer_norm.py:278 `_rms_fwd_kernel` (launched by
// `_norm_fwd_pallas` with beta None, :126 / :144).  Same arithmetic: per
// row rstd = rsqrt(mean(x^2) + eps) in fp32, y = x * rstd * gamma in x's
// dtype, rstd stored as fp32; no mean, no beta.  Bound: bytes,
// N*H*(in + out bytes) + 4*H (gamma) + 4*N (rstd), one pass over memory as
// above: at 4096 x 768 fp32, 25.2 MB, ~7.5 us.  Its one reduction (the sum
// of squares) is taken while the row is loaded.  It takes the packs and
// the layout above.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxH = 8192;
constexpr int kWarpElems = 32;  // floats a lane holds in a warp layout
constexpr int kBlockThreads = 512;

// Packs a lane of the forward's warp layout takes: 32 elements, or eight
// 16-byte half packs (64 elements: a bf16 or fp16 row up to 2048).
template <int VEC>
constexpr int fwd_warp_chunks() {
  return VEC == 8 ? 8 : kWarpElems / VEC;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// VEC consecutive elements moved as one load or store (16 bytes when
// VEC * sizeof(T) == 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// VEC floats of gamma or beta from p + col, in packs of up to 4 floats
// (the caller keeps p 4 * min(VEC, 4)-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_params(const float* p, int col,
                                            float (&out)[VEC]) {
  constexpr int W = VEC < 4 ? VEC : 4;
#pragma unroll
  for (int i = 0; i < VEC; i += W) {
    const Pack<float, W> q = *reinterpret_cast<const Pack<float, W>*>(
        p + col + i);
#pragma unroll
    for (int j = 0; j < W; ++j) out[i + j] = q.v[j];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the TPR threads of one row group; every thread gets the total.
template <int TPR>
__device__ __forceinline__ float group_sum(float v, float* smem) {
  v = warp_sum(v);
  if (TPR == 32) return v;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = lane < TPR / 32 ? smem[lane] : 0.f;
  v = warp_sum(v);
  __syncthreads();  // smem is written again by the next reduction
  return v;
}

// kMean: LayerNorm.  Without it RMSNorm: beta and mean_out are null.
template <typename T, int VEC, int TPR, int CHUNKS, bool kMean>
__global__ void __launch_bounds__(TPR == 32 ? 128 : TPR)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int64_t n_rows, int h, float eps) {
  __shared__ float smem[32];
  constexpr int kRowsPerBlock = TPR == 32 ? 4 : 1;
  const int tid = TPR == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      (TPR == 32 ? (threadIdx.x >> 5) : 0);
  // A whole row group leaves together: a 512-thread group is the whole
  // block, so no thread skips a __syncthreads another one waits at.
  if (row >= n_rows) return;
  const T* xr = x + row * h;
  T* yr = y + row * h;

  // The row's loads first, none used in its branch, so that they are all
  // in flight together; then the sum (lanes past the row hold 0).
  float v[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * TPR + tid) * VEC;
    if (col < h) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + col);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[c][i] = to_float(p.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[c][i] = 0.f;
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      sum += kMean ? v[c][i] : v[c][i] * v[c][i];
  const float fh = static_cast<float>(h);
  float mean = 0.f, rstd;
  if constexpr (kMean) {
    mean = group_sum<TPR>(sum, smem) / fh;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (c * TPR + tid) * VEC;
      if (col < h) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = v[c][i] - mean;
          sq += d * d;
        }
      }
    }
    rstd = rsqrtf(group_sum<TPR>(sq, smem) / fh + eps);
  } else {
    rstd = rsqrtf(group_sum<TPR>(sum, smem) / fh + eps);
  }

#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * TPR + tid) * VEC;
    if (col < h) {
      float gv[VEC], bv[VEC];
      load_params<VEC>(gamma, col, gv);
      if constexpr (kMean) load_params<VEC>(beta, col, bv);
      Pack<T, VEC> p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if constexpr (kMean)
          p.v[i] = from_float<T>((v[c][i] - mean) * rstd * gv[i] + bv[i]);
        else
          p.v[i] = from_float<T>(v[c][i] * rstd * gv[i]);
      }
      *reinterpret_cast<Pack<T, VEC>*>(yr + col) = p;
    }
  }
  if (tid == 0) {
    if constexpr (kMean) mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int VEC, bool kMean>
int launch(const void* x, const float* gamma, const float* beta, void* y,
           float* mean, float* rstd, int64_t n, int h, float eps,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  constexpr int kChunks = fwd_warp_chunks<VEC>();
  if (h <= kChunks * 32 * VEC) {
    const int64_t blocks = (n + 3) / 4;
    ln_fwd_kernel<T, VEC, 32, kChunks, kMean>
        <<<static_cast<unsigned>(blocks), 128, 0, stream>>>(
            xt, gamma, beta, yt, mean, rstd, n, h, eps);
  } else {
    ln_fwd_kernel<T, VEC, kBlockThreads, kMaxH / (kBlockThreads * VEC), kMean>
        <<<static_cast<unsigned>(n), kBlockThreads, 0, stream>>>(
            xt, gamma, beta, yt, mean, rstd, n, h, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's pack width: the widest power of two up to 16 / sizeof(T)
// that divides h and to whose packs x and y are aligned, and gamma and
// beta (null for RMSNorm) to theirs of min(VEC, 4) floats.
template <typename T>
int vec_width(const void* x, const void* y, const float* gamma,
              const float* beta, int h) {
  const auto aligned = [](const void* p, int bytes) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  for (int v = 16 / static_cast<int>(sizeof(T)); v > 1; v /= 2) {
    const int pb = static_cast<int>(sizeof(T)) * v;
    const int gb = 4 * (v < 4 ? v : 4);
    if (h % v == 0 && aligned(x, pb) && aligned(y, pb) &&
        aligned(gamma, gb) && aligned(beta, gb))
      return v;
  }
  return 1;
}

template <typename T, bool kMean>
int dispatch(const void* x, const float* gamma, const float* beta, void* y,
             float* mean, float* rstd, int64_t n, int h, float eps,
             cudaStream_t stream) {
  const int v = vec_width<T>(x, y, gamma, beta, h);
  if constexpr (sizeof(T) == 2) {  // 16-byte packs of 8 halves
    if (v == 8)
      return launch<T, 8, kMean>(x, gamma, beta, y, mean, rstd, n, h, eps,
                                 stream);
  }
  if (v == 4)
    return launch<T, 4, kMean>(x, gamma, beta, y, mean, rstd, n, h, eps,
                               stream);
  if (v == 2)
    return launch<T, 2, kMean>(x, gamma, beta, y, mean, rstd, n, h, eps,
                               stream);
  return launch<T, 1, kMean>(x, gamma, beta, y, mean, rstd, n, h, eps,
                             stream);
}

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces apex_example_tpu/ops/layer_norm.py:82 `_bwd_kernel` (launched by
// `_norm_bwd_pallas`, :161 / :192).  Same arithmetic (:88-99): per row,
// x_hat = (x - mean) * rstd from the saved fp32 stats, wdy = dy * gamma,
// c1 = mean(wdy), c2 = mean(wdy * x_hat), dx = rstd * (wdy - c1 - x_hat*c2)
// in x's dtype; dgamma = sum over rows of dy * x_hat, dbeta = sum of dy, fp32.
//
// Bound: bytes.  x and dy are read once and dx written once (N*H*3 elements)
// plus gamma, the stats and dgamma/dbeta; ~15 operations per element.  At
// the training shape (4096 x 768 fp32) that is 37.8 MB, ~11.3 us.
//
// The TPU kernel sums dgamma/dbeta into one output block across grid steps
// that run in order; GPU blocks run concurrently, in no order.  So every
// layout adds per-group partials in a fixed order, with no float atomics:
// dgamma and dbeta repeat bitwise on one card.  ops/layer_norm.py
// `bwd_geometry` picks the layout, the grid and the pack width (VEC
// neighbouring elements a load or store).
//
// Rows of up to 1024 elements: `ln_bwd_persist_kernel`, one launch of a
// persistent grid.
// - The grid holds SMs x resident blocks of kBwdWarps warps (the occupancy
//   on this device, cached per library: `apex_norm_bwd_resident`), or fewer
//   where fewer give every warp a row (up to 256 rows: a warp a row), and
//   warp w of W takes rows [w N / W, (w + 1) N / W): contiguous shares that
//   differ by one row at most, every row in one share.
// - Loads ahead of use.  A lane issues all its x and dy loads of a row
//   (zero packs past H; the branch guards the loads and the stores, never
//   a use) before it uses one, and the next row's go out before this row's
//   reductions and stores: two register sets, for rows of up to 768
//   elements (kAhead).  A ring of three rows a warp in shared memory,
//   filled by cp.async, was 1% faster at 4096 and 8192 x 768 fp32, 9% at
//   16384 x 768 bf16 and 17% slower at 6144 x 410 on an H100 (PERF.md).
// - gamma is loaded once per warp into registers, in packs of up to four
//   floats (rows over 768 elements reload it per row, from L1); the row's
//   packs are held as loaded (a half row in half the registers) and
//   converted where they are used.
// - Packs of the widest power of two up to 16 bytes that divides H with
//   the pointers aligned: 410 takes fp32 and bf16 pairs.
// - One launch.  Each warp keeps its dgamma/dbeta partials in registers;
//   the block adds its warps' in warp order through shared memory into one
//   workspace row.  Then a two-level finish, each level told by an integer
//   ticket behind __threadfence: the last block of each group of
//   kBwdTreeGroup blocks adds the group's rows in order into a tree row,
//   and the last of those adds the tree rows in order into dgamma and
//   dbeta (a grid of one group adds its rows into them at once).  Each
//   resets its ticket for the next launch.  (One last block adding all
//   SMs x resident rows alone would read ~1 MB at 4096 x 768 through one
//   SM: several microseconds of tail.)
//
// Wider rows, up to kMaxH: `ln_bwd_kernel`, a 512-thread block per
// group of rows (a row each up to 256 rows; group g takes rows g,
// g + n_groups, ...), and `ln_bwd_colsum_kernel`, a second launch that
// adds the groups' workspace rows per column in a fixed order.
//
// RMSNorm backward: the same kernels with kMean = false.  Replaces
// apex_example_tpu/ops/layer_norm.py:285 `_rms_bwd_kernel` (launched by
// `_norm_bwd_pallas` with mean None, :161 / :192).  Same arithmetic
// (:285-294): x_hat = x * rstd, wdy = dy * gamma, c2 = mean(wdy * x_hat),
// dx = rstd * (wdy - x_hat * c2) in x's dtype, dgamma = sum over rows of
// dy * x_hat in fp32; no c1 and no dbeta.  Bound: bytes, 3*N*H elements
// (x, dy read; dx written) + 4*H + 4*N (4096 x 768 fp32: 37.8 MB, ~11.3
// us).  The Pallas kernel adds dgamma across grid steps that run in order
// (:292); here the layouts above, one plane of partials.

constexpr int kBwdColTile = 32;     // columns per block of the column sum
constexpr int kBwdColSegs = 16;     // workspace-row segments per block
constexpr int kBwdWarps = 8;        // warps a block of ln_bwd_persist_kernel
constexpr int kBwdTreeGroup = 16;   // blocks whose rows one block adds first

enum BwdLayout { kWide = 0, kPersist = 1 };

// One row of the backward: dx, and the row's dy * x_hat and dy added into
// the thread's column partials pg and pb.  kMean: LayerNorm; without it
// RMSNorm (mean_in null, pb untouched).
template <typename T, int VEC, int TPR, int CHUNKS, bool kMean>
__device__ __forceinline__ void bwd_row(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ gamma, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, T* __restrict__ dx, int64_t row, int h,
    int tid, float* smem, float (&pg)[CHUNKS][VEC], float (&pb)[CHUNKS][VEC]) {
  const float fh = static_cast<float>(h);
  const float mu = kMean ? mean_in[row] : 0.f;
  const float rs = rstd_in[row];
  const T* xr = x + row * h;
  const T* dyr = dy + row * h;
  float xh[CHUNKS][VEC], d[CHUNKS][VEC];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * TPR + tid) * VEC;
    if (col < h) {
      const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(xr + col);
      const Pack<T, VEC> pd =
          *reinterpret_cast<const Pack<T, VEC>*>(dyr + col);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        xh[c][i] = (to_float(px.v[i]) - mu) * rs;
        d[c][i] = to_float(pd.v[i]);
        pg[c][i] += d[c][i] * xh[c][i];
        if (kMean) pb[c][i] += d[c][i];
        // __fmul_rn: never fused into an FMA, so the sums and dx below
        // see the same rounded wdy (at H = 1, wdy - c1 must be 0 exactly,
        // and rstd = 1/sqrt(eps) would magnify a fused product's error).
        const float wdy = __fmul_rn(d[c][i], gamma[col + i]);
        if (kMean) s1 += wdy;
        s2 += wdy * xh[c][i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) xh[c][i] = d[c][i] = 0.f;
    }
  }
  const float c1 = kMean ? group_sum<TPR>(s1, smem) / fh : 0.f;
  const float c2 = group_sum<TPR>(s2, smem) / fh;
  T* dxr = dx + row * h;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * TPR + tid) * VEC;
    if (col < h) {
      Pack<T, VEC> p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float wdy = __fmul_rn(d[c][i], gamma[col + i]);
        if constexpr (kMean)
          p.v[i] = from_float<T>(rs * (wdy - c1 - xh[c][i] * c2));
        else
          p.v[i] = from_float<T>(rs * (wdy - xh[c][i] * c2));
      }
      *reinterpret_cast<Pack<T, VEC>*>(dxr + col) = p;
    }
  }
}

// Wide rows: a 512-thread block per row group.  kMean: LayerNorm.  Without
// it RMSNorm: mean_in and ws_db are null.
template <typename T, int VEC, int CHUNKS, bool kMean>
__global__ void __launch_bounds__(kBlockThreads)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma,
                  const float* __restrict__ mean_in,
                  const float* __restrict__ rstd_in, T* __restrict__ dx,
                  float* __restrict__ ws_dg, float* __restrict__ ws_db,
                  int64_t n_rows, int h) {
  __shared__ float smem[32];
  const int tid = threadIdx.x;
  const int64_t group = blockIdx.x, n_groups = gridDim.x;

  float pg[CHUNKS][VEC], pb[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) pg[c][i] = pb[c][i] = 0.f;
  for (int64_t row = group; row < n_rows; row += n_groups)
    bwd_row<T, VEC, kBlockThreads, CHUNKS, kMean>(
        x, dy, gamma, mean_in, rstd_in, dx, row, h, tid, smem, pg, pb);

  float* wg = ws_dg + group * h;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * kBlockThreads + tid) * VEC;
    if (col < h) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        wg[col + i] = pg[c][i];
        if constexpr (kMean) ws_db[group * h + col + i] = pb[c][i];
      }
    }
  }
}

// Whether this block is the last of `count` to take a number from
// `ticket`: every thread's writes are fenced before thread 0 takes it, and
// the last block fences again before it reads what the others wrote.
__device__ __forceinline__ bool last_to_arrive(unsigned int* ticket,
                                               unsigned count, bool* last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(ticket, 1u) == count - 1;
  __syncthreads();
  if (*last) __threadfence();
  return *last;
}

// W floats at p (W * 4-byte aligned), read through L2 only: other blocks
// wrote them in this launch.
template <int W>
__device__ __forceinline__ Pack<float, W> ldcg_pack(const float* p) {
  Pack<float, W> r;
  if constexpr (W == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    r.v[0] = v.x, r.v[1] = v.y, r.v[2] = v.z, r.v[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    r.v[0] = v.x, r.v[1] = v.y;
  } else {
    r.v[0] = __ldcg(p);
  }
  return r;
}

constexpr unsigned kSumBatch = 8;  // rows whose loads go out together

// acc[p] += rows k .. k + n - 1 of plane p of src at column j, in order,
// every load issued before the first add (kFull: n is kSumBatch).
template <int W, int P, bool kFull>
__device__ __forceinline__ void add_rows(const float* src, unsigned k,
                                         unsigned n, int64_t stride, int h,
                                         int j, float (&acc)[P][W]) {
  Pack<float, W> v[kSumBatch][P];
#pragma unroll
  for (unsigned b = 0; b < kSumBatch; ++b)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (kFull || b < n) {
        v[b][p] = ldcg_pack<W>(src + (k + b) * stride + p * h + j);
      } else {
#pragma unroll
        for (int u = 0; u < W; ++u) v[b][p].v[u] = 0.f;
      }
    }
#pragma unroll
  for (unsigned b = 0; b < kSumBatch; ++b)
    if (kFull || b < n)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int u = 0; u < W; ++u) acc[p][u] += v[b][p].v[u];
}

// For every column j < h of each of the P planes of h floats in a row of
// src: the sum over k < rows, in order, of row k's, into lo (plane 0) and
// hi (plane 1), W columns a thread at a time.  The loads of up to
// kSumBatch rows of both planes go out together, the last few rows' too
// (at 37 x 777 fp32, a few rows of single floats, loading one row after
// another made the launch 38% slower).
template <int W, int P>
__device__ __forceinline__ void sum_rows(const float* src, unsigned rows,
                                         int64_t stride, int h, float* lo,
                                         float* hi) {
  for (int j = threadIdx.x * W; j < h; j += kBwdWarps * 32 * W) {
    float acc[P][W];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int u = 0; u < W; ++u) acc[p][u] = 0.f;
    unsigned k = 0;
    for (; k + kSumBatch <= rows; k += kSumBatch)
      add_rows<W, P, true>(src, k, kSumBatch, stride, h, j, acc);
    if (k < rows) add_rows<W, P, false>(src, k, rows - k, stride, h, j, acc);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      Pack<float, W> out;
#pragma unroll
      for (int u = 0; u < W; ++u) out.v[u] = acc[p][u];
      *reinterpret_cast<Pack<float, W>*>((p ? hi : lo) + j) = out;
    }
  }
}

// The lane's gamma, in packs of up to four floats (zero past h).
template <int VEC, int CHUNKS>
__device__ __forceinline__ void load_gamma(const float* __restrict__ gamma,
                                           int h, int lane,
                                           float (&g)[CHUNKS][VEC]) {
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < h) {
      load_params<VEC>(gamma, col, g[c]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) g[c][i] = 0.f;
    }
  }
}

// One row's x and dy packs as loaded, and its saved stats.
template <typename T, int VEC, int CHUNKS>
struct RowPacks {
  Pack<T, VEC> x[CHUNKS], d[CHUNKS];
  float mu, rs;
};

// Issues every load of row `row` (zero packs past h) and uses none.
template <typename T, int VEC, int CHUNKS, bool kMean>
__device__ __forceinline__ void load_row(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
    int64_t row, int h, int lane, RowPacks<T, VEC, CHUNKS>& r) {
  const T* xr = x + row * h;
  const T* dr = dy + row * h;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < h) {
      r.x[c] = *reinterpret_cast<const Pack<T, VEC>*>(xr + col);
      r.d[c] = *reinterpret_cast<const Pack<T, VEC>*>(dr + col);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        r.x[c].v[i] = r.d[c].v[i] = from_float<T>(0.f);
    }
  }
  r.mu = kMean ? mean_in[row] : 0.f;
  r.rs = rstd_in[row];
}

// dx of one row from its packs (stored at dxr), and its dy * x_hat and dy
// added into the lane's column partials; g holds the lane's gamma (zero
// past h, where dy is zero too, so the pad adds nothing).  The arithmetic
// of bwd_row.
template <typename T, int VEC, int CHUNKS, bool kMean>
__device__ __forceinline__ void bwd_packs(
    const RowPacks<T, VEC, CHUNKS>& r, const float (&g)[CHUNKS][VEC],
    T* __restrict__ dxr, int h, int lane, float (&pg)[CHUNKS][VEC],
    float (&pb)[CHUNKS][VEC]) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xh = (to_float(r.x[c].v[i]) - r.mu) * r.rs;
      const float d = to_float(r.d[c].v[i]);
      const float wdy = __fmul_rn(d, g[c][i]);
      pg[c][i] += d * xh;
      if constexpr (kMean) {
        pb[c][i] += d;
        s1 += wdy;
      }
      s2 += wdy * xh;
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {  // both sums' shuffles together
    if constexpr (kMean) s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float fh = static_cast<float>(h);
  const float c1 = kMean ? s1 / fh : 0.f;
  const float c2 = s2 / fh;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < h) {
      Pack<T, VEC> p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (to_float(r.x[c].v[i]) - r.mu) * r.rs;
        const float wdy = __fmul_rn(to_float(r.d[c].v[i]), g[c][i]);
        if constexpr (kMean)
          p.v[i] = from_float<T>(r.rs * (wdy - c1 - xh * c2));
        else
          p.v[i] = from_float<T>(r.rs * (wdy - xh * c2));
      }
      *reinterpret_cast<Pack<T, VEC>*>(dxr + col) = p;
    }
  }
}

// Rows of up to CHUNKS * 32 * VEC elements: see the note above.
// ws: [gridDim.x + tree rows, planes, h] floats; tickets: 1 + tree rows
// counters, 0 at the launch and 0 again after it.  One block an SM is
// enough (the row ahead hides the loads): without that bound ptxas fit
// two instances into 128 registers with a 4-byte spill.
template <typename T, int VEC, int CHUNKS, bool kMean>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
    ln_bwd_persist_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ gamma,
                          const float* __restrict__ mean_in,
                          const float* __restrict__ rstd_in,
                          T* __restrict__ dx, float* __restrict__ ws,
                          float* __restrict__ dgamma,
                          float* __restrict__ dbeta, unsigned int* tickets,
                          int64_t n_rows, int h) {
  constexpr int kPlanes = kMean ? 2 : 1;  // dgamma's partials, dbeta's
  constexpr int kThreads = kBwdWarps * 32;
  constexpr int kW = VEC < 4 ? VEC : 4;   // floats a pack of the partials
  // Up to 24 elements a lane (rows of up to 768), two row sets and gamma
  // in registers: the next row is loaded before this one is used (209
  // registers at 768 fp32).  Wider rows, one set, loaded after the row
  // before is done, and gamma reloaded per row: two sets, gamma and the
  // partials would spill.
  constexpr bool kAhead = CHUNKS * VEC <= 24;
  __shared__ __align__(16) float part[kBwdWarps][CHUNKS * 32 * VEC];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_w = static_cast<int64_t>(gridDim.x) * kBwdWarps;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kBwdWarps + warp;
  const int64_t r0 = w * n_rows / n_w, r1 = (w + 1) * n_rows / n_w;

  float g[CHUNKS][VEC], pg[CHUNKS][VEC], pb[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) pg[c][i] = pb[c][i] = 0.f;

  if constexpr (kAhead) {
    load_gamma<VEC, CHUNKS>(gamma, h, lane, g);
    RowPacks<T, VEC, CHUNKS> a, b;
    if (r0 < r1)
      load_row<T, VEC, CHUNKS, kMean>(x, dy, mean_in, rstd_in, r0, h, lane, a);
    for (int64_t r = r0; r < r1; r += 2) {
      if (r + 1 < r1)
        load_row<T, VEC, CHUNKS, kMean>(x, dy, mean_in, rstd_in, r + 1, h,
                                        lane, b);
      bwd_packs<T, VEC, CHUNKS, kMean>(a, g, dx + r * h, h, lane, pg, pb);
      if (r + 1 >= r1) break;
      if (r + 2 < r1)
        load_row<T, VEC, CHUNKS, kMean>(x, dy, mean_in, rstd_in, r + 2, h,
                                        lane, a);
      bwd_packs<T, VEC, CHUNKS, kMean>(b, g, dx + (r + 1) * h, h, lane, pg,
                                       pb);
    }
  } else {
    RowPacks<T, VEC, CHUNKS> a;
    for (int64_t r = r0; r < r1; ++r) {
      // gamma again from L1 each row, and every load after the row
      // before's stores: nothing but the partials stays live across rows
      asm volatile("" ::: "memory");
      load_gamma<VEC, CHUNKS>(gamma, h, lane, g);
      load_row<T, VEC, CHUNKS, kMean>(x, dy, mean_in, rstd_in, r, h, lane, a);
      bwd_packs<T, VEC, CHUNKS, kMean>(a, g, dx + r * h, h, lane, pg, pb);
    }
  }

  // The block's warps' partials, added per column in warp order, into
  // workspace row blockIdx.x.
  const int64_t stride = static_cast<int64_t>(kPlanes) * h;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int i = 0; i < VEC; i += kW) {
        Pack<float, kW> q;
#pragma unroll
        for (int u = 0; u < kW; ++u) q.v[u] = p ? pb[c][i + u] : pg[c][i + u];
        *reinterpret_cast<Pack<float, kW>*>(
            &part[warp][(c * 32 + lane) * VEC + i]) = q;
      }
    __syncthreads();
    float* row = ws + blockIdx.x * stride + p * h;
    for (int col = threadIdx.x; col < h; col += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kBwdWarps; ++k) s += part[k][col];
      row[col] = s;
    }
    __syncthreads();  // part is written again by the next plane
  }

  // The group's last block adds the group's rows into its tree row; the
  // last of the groups adds the tree rows into dgamma and dbeta.
  const unsigned groups = (gridDim.x + kBwdTreeGroup - 1) / kBwdTreeGroup;
  const unsigned grp = blockIdx.x / kBwdTreeGroup;
  const unsigned first = grp * kBwdTreeGroup;
  const unsigned members =
      min(static_cast<unsigned>(kBwdTreeGroup), gridDim.x - first);
  float* tree = ws + gridDim.x * stride;
  if (!last_to_arrive(tickets + 1 + grp, members, &last)) return;
  if (groups == 1) {  // the group's rows are all the rows
    sum_rows<kW, kPlanes>(ws, members, stride, h, dgamma, dbeta);
    if (threadIdx.x == 0) tickets[1] = 0u;
    return;
  }
  float* mine = tree + grp * stride;
  sum_rows<kW, kPlanes>(ws + first * stride, members, stride, h, mine,
                        mine + h);
  if (threadIdx.x == 0) tickets[1 + grp] = 0u;
  if (!last_to_arrive(tickets, groups, &last)) return;
  sum_rows<kW, kPlanes>(tree, groups, stride, h, dgamma, dbeta);
  if (threadIdx.x == 0) tickets[0] = 0u;
}

// dgamma[col] = sum over the workspace's rows, in a fixed order: segment s
// of a block adds rows s, s + kBwdColSegs, ...; then the segments are added
// in order 0..kBwdColSegs-1.  Without kMean (RMSNorm) ws_db and dbeta are
// null and only dgamma is summed.
template <bool kMean>
__global__ void __launch_bounds__(kBwdColTile * kBwdColSegs)
    ln_bwd_colsum_kernel(const float* __restrict__ ws_dg,
                         const float* __restrict__ ws_db,
                         float* __restrict__ dgamma,
                         float* __restrict__ dbeta, int h, int64_t n_groups) {
  __shared__ float sg[kBwdColSegs][kBwdColTile + 1];
  __shared__ float sb[kBwdColSegs][kBwdColTile + 1];
  const int col = blockIdx.x * kBwdColTile + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (col < h) {
    for (int64_t r = threadIdx.y; r < n_groups; r += kBwdColSegs) {
      a += ws_dg[r * h + col];
      if (kMean) b += ws_db[r * h + col];
    }
  }
  sg[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && col < h) {
    float s = 0.f, t = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdColSegs; ++k) {
      s += sg[k][threadIdx.x];
      t += sb[k][threadIdx.x];
    }
    dgamma[col] = s;
    if (kMean) dbeta[col] = t;
  }
}

// ln_bwd_persist_kernel's lanes hold CHUNKS packs of a row: the fewest of
// a quarter, a half, three quarters or all of kWarpElems / VEC that cover
// h (so 768 takes 6 fp32 packs of 4, 410 8 pairs).  Calls
// op.template go<T, VEC, CHUNKS>(); -2 if h is too wide.
template <typename T, int VEC, typename Op>
int by_chunks(const Op& op, int h) {
  constexpr int kMax = kWarpElems / VEC;
  const int need = (h + 32 * VEC - 1) / (32 * VEC);
  if (need <= kMax / 4) return op.template go<T, VEC, kMax / 4>();
  if (need <= kMax / 2) return op.template go<T, VEC, kMax / 2>();
  if (need <= 3 * kMax / 4) return op.template go<T, VEC, 3 * kMax / 4>();
  if (need <= kMax) return op.template go<T, VEC, kMax>();
  return -2;
}

// The backward's pointers and shape.  ws: the workspace; tickets and
// tree: see ln_bwd_persist_kernel.
struct BwdArgs {
  const void *x, *dy;
  const float *gamma, *mean, *rstd;
  void* dx;
  float *dgamma, *dbeta, *ws;
  unsigned int* tickets;
  int64_t n;
  int h;
  int64_t blocks, tree;
  int layout;
  cudaStream_t stream;
};

template <bool kMean>
struct BwdLaunch {
  BwdArgs a;

  template <typename T, int VEC, int CHUNKS>
  int go() const {
    ln_bwd_persist_kernel<T, VEC, CHUNKS, kMean>
        <<<static_cast<unsigned>(a.blocks), kBwdWarps * 32, 0, a.stream>>>(
            static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.gamma,
            a.mean, a.rstd, static_cast<T*>(a.dx), a.ws, a.dgamma, a.dbeta,
            a.tickets, a.n, a.h);
    return static_cast<int>(cudaGetLastError());
  }

  template <typename T, int VEC>
  int run() const {
    if (a.layout == kPersist) return by_chunks<T, VEC>(*this, a.h);
    // Wide rows take 16-byte packs or single elements; their workspace is
    // [planes, blocks, h].
    if constexpr (VEC == 1 || VEC * sizeof(T) == 16) {
      const T* xt = static_cast<const T*>(a.x);
      const T* dyt = static_cast<const T*>(a.dy);
      T* dxt = static_cast<T*>(a.dx);
      float* ws_db = kMean ? a.ws + a.blocks * a.h : nullptr;
      ln_bwd_kernel<T, VEC, kMaxH / (kBlockThreads * VEC), kMean>
          <<<static_cast<unsigned>(a.blocks), kBlockThreads, 0, a.stream>>>(
              xt, dyt, a.gamma, a.mean, a.rstd, dxt, a.ws, ws_db, a.n, a.h);
      const int rc = static_cast<int>(cudaGetLastError());
      if (rc != 0) return rc;
      const unsigned col_blocks =
          static_cast<unsigned>((a.h + kBwdColTile - 1) / kBwdColTile);
      ln_bwd_colsum_kernel<kMean>
          <<<col_blocks, dim3(kBwdColTile, kBwdColSegs), 0, a.stream>>>(
              a.ws, ws_db, a.dgamma, a.dbeta, a.h, a.blocks);
      return static_cast<int>(cudaGetLastError());
    }
    return -5;
  }
};

template <bool kMean>
struct BwdResident {
  int h;
  int* blocks;

  template <typename T, int VEC, int CHUNKS>
  int go() const {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ln_bwd_persist_kernel<T, VEC, CHUNKS, kMean>, kBwdWarps * 32,
        0));
  }

  template <typename T, int VEC>
  int run() const {
    return by_chunks<T, VEC>(*this, h);
  }
};

// op.template run<T, VEC>() for this dtype and pack width; -1 for an
// unknown dtype, -5 for a width the dtype has no pack of.
template <typename Op>
int by_dtype_vec(const Op& op, int dtype, int vec) {
  switch (dtype * 16 + vec) {
    case 0 * 16 + 1:
      return op.template run<float, 1>();
    case 0 * 16 + 2:
      return op.template run<float, 2>();
    case 0 * 16 + 4:
      return op.template run<float, 4>();
    case 1 * 16 + 1:
      return op.template run<__nv_bfloat16, 1>();
    case 1 * 16 + 2:
      return op.template run<__nv_bfloat16, 2>();
    case 1 * 16 + 4:
      return op.template run<__nv_bfloat16, 4>();
    case 1 * 16 + 8:
      return op.template run<__nv_bfloat16, 8>();
    case 2 * 16 + 1:
      return op.template run<__half, 1>();
    case 2 * 16 + 2:
      return op.template run<__half, 2>();
    case 2 * 16 + 4:
      return op.template run<__half, 4>();
    case 2 * 16 + 8:
      return op.template run<__half, 8>();
    default:
      return dtype < 0 || dtype > 2 ? -1 : -5;
  }
}

// Checks what the backward's caller chose (ops/layer_norm.py
// `bwd_geometry`), then launches.  Argument errors are negative.
template <bool kMean>
int run_bwd(const BwdArgs& a, int vec, int dtype) {
  if (a.h < 1 || a.h > kMaxH) return -2;
  if (a.n < 1 || a.n > 0x7fffffffLL) return -3;
  if (dtype < 0 || dtype > 2) return -1;
  const int esize = dtype == 0 ? 4 : 2;
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  if (vec < 1 || vec > 16 / esize || (vec & (vec - 1)) != 0 ||
      a.h % vec != 0 || !aligned(a.x, vec * esize) ||
      !aligned(a.dy, vec * esize) || !aligned(a.dx, vec * esize) ||
      (a.layout == kPersist && !aligned(a.gamma, 4 * (vec < 4 ? vec : 4))))
    return -5;
  switch (a.layout) {
    case kWide:
      if (a.blocks < 1 || a.blocks > a.n || a.tree != 0) return -4;
      break;
    case kPersist:
      // the workspace and the tickets were sized for this tree
      if (a.h > kWarpElems * 32 || a.tickets == nullptr || a.blocks < 1 ||
          a.blocks > 65535 ||
          a.tree != (a.blocks + kBwdTreeGroup - 1) / kBwdTreeGroup)
        return -4;
      break;
    default:
      return -6;
  }
  return by_dtype_vec(BwdLaunch<kMean>{a}, dtype, vec);
}

}  // namespace

// Backward.  dx in x's dtype (dy has it too); dgamma, dbeta fp32 (H,).
// The caller picks the layout (0 wide rows, 1 the persistent grid), the
// blocks, the tree rows (layout 1: ceil(blocks / 16), else 0) and the pack
// width `vec` (ops/layer_norm.py `bwd_geometry`): workspace
// 2 * (blocks + tree_rows) * H floats of scratch; tickets tree_rows + 1
// counters, 0 at the launch and 0 again after it.  Argument errors are
// negative; a launch error is the cudaError_t value.
extern "C" int apex_layer_norm_bwd(const void* x, const void* dy,
                                   const void* gamma, const void* mean,
                                   const void* rstd, void* dx, void* dgamma,
                                   void* dbeta, void* workspace,
                                   void* tickets, long long n_rows, int h,
                                   long long blocks, long long tree_rows,
                                   int layout, int vec, int dtype,
                                   void* stream) {
  const BwdArgs a{x, dy, static_cast<const float*>(gamma),
                  static_cast<const float*>(mean),
                  static_cast<const float*>(rstd), dx,
                  static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                  static_cast<float*>(workspace),
                  static_cast<unsigned int*>(tickets), n_rows, h, blocks,
                  tree_rows, layout, static_cast<cudaStream_t>(stream)};
  return run_bwd<true>(a, vec, dtype);
}

// RMSNorm backward: dx in x's dtype (dy has it too), dgamma fp32 (H,);
// workspace rows * H floats of scratch (one plane); the rest as
// LayerNorm's.
extern "C" int apex_rms_norm_bwd(const void* x, const void* dy,
                                 const void* gamma, const void* rstd,
                                 void* dx, void* dgamma, void* workspace,
                                 void* tickets, long long n_rows, int h,
                                 long long blocks, long long tree_rows,
                                 int layout, int vec, int dtype,
                                 void* stream) {
  const BwdArgs a{x, dy, static_cast<const float*>(gamma), nullptr,
                  static_cast<const float*>(rstd), dx,
                  static_cast<float*>(dgamma), nullptr,
                  static_cast<float*>(workspace),
                  static_cast<unsigned int*>(tickets), n_rows, h, blocks,
                  tree_rows, layout, static_cast<cudaStream_t>(stream)};
  return run_bwd<false>(a, vec, dtype);
}

// *blocks: how many blocks of ln_bwd_persist_kernel for rows of h elements
// of this dtype in packs of vec (kmean 1 LayerNorm, 0 RMSNorm) are
// resident on one SM of the current device.  Errors as above.
extern "C" int apex_norm_bwd_resident(int kmean, int dtype, int vec, int h,
                                      int* blocks) {
  if (h < 1 || h > kWarpElems * 32) return -2;
  if (kmean) return by_dtype_vec(BwdResident<true>{h, blocks}, dtype, vec);
  return by_dtype_vec(BwdResident<false>{h, blocks}, dtype, vec);
}

// Argument errors are negative; a launch error is the cudaError_t value.
extern "C" int apex_layer_norm_fwd(const void* x, const void* gamma,
                                   const void* beta, void* y, void* mean,
                                   void* rstd, long long n_rows, int h,
                                   float eps, int dtype, void* stream) {
  if (h < 1 || h > kMaxH) return -2;
  if (n_rows < 1 || n_rows > 0x7fffffffLL) return -3;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float, true>(x, g, b, y, m, r, n_rows, h, eps, s);
    case 1:
      return dispatch<__nv_bfloat16, true>(x, g, b, y, m, r, n_rows, h, eps,
                                           s);
    case 2:
      return dispatch<__half, true>(x, g, b, y, m, r, n_rows, h, eps, s);
    default:
      return -1;
  }
}

// RMSNorm forward: y in x's dtype, rstd fp32 (N,), gamma fp32 (H,).
// Argument errors are negative; a launch error is the cudaError_t value.
extern "C" int apex_rms_norm_fwd(const void* x, const void* gamma, void* y,
                                 void* rstd, long long n_rows, int h,
                                 float eps, int dtype, void* stream) {
  if (h < 1 || h > kMaxH) return -2;
  if (n_rows < 1 || n_rows > 0x7fffffffLL) return -3;
  const float* g = static_cast<const float*>(gamma);
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float, false>(x, g, nullptr, y, nullptr, r, n_rows, h,
                                    eps, s);
    case 1:
      return dispatch<__nv_bfloat16, false>(x, g, nullptr, y, nullptr, r,
                                            n_rows, h, eps, s);
    case 2:
      return dispatch<__half, false>(x, g, nullptr, y, nullptr, r, n_rows, h,
                                     eps, s);
    default:
      return -1;
  }
}

extern "C" int apex_layer_norm_max_h() { return kMaxH; }

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
