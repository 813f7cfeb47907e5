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
// Design.  The TPU kernel sums dgamma/dbeta into one output block across
// grid steps that run in order; GPU blocks run concurrently.  So the rows are
// dealt to n_groups row groups (a warp each for H <= 1024, a 512-thread
// block each above), group g taking rows g, g + n_groups, ... in that order.
// A group holds one row at a time in registers (loaded once: x_hat and dy),
// reduces c1 and c2 with shuffles, writes dx, and keeps running column sums
// of dy * x_hat and dy in registers; at the end it writes them as row g of a
// [n_groups, H] fp32 workspace.  A second launch adds the workspace's rows
// per column in a fixed order.  No float atomics, so dgamma and dbeta repeat
// bitwise.  Per thread 32 elements at most (the warp layout) or 16 (the
// block layout), so the four register arrays stay within 128 floats.
//
// Few rows (ops/layer_norm.py `bwd_row_groups`: up to 256, a group a row).
// Four rows a group left most SMs idle and each warp's rows in series:
// 128 x 768 took 8 blocks, and the column pass cost a launch of its own.
// There every row gets its own group.  A row of at most 1024 elements
// takes `ln_bwd_rows_kernel`: eight rows a block, a warp a row, the
// block's partials added in row order into one workspace row, and the last
// block (an integer ticket behind __threadfence, reset by that block) adds
// the workspace rows per column in order: one launch, still no float
// atomics.  (Its warps each taking every eighth row, all 32 columns of a
// lane loaded at once, was slower at 128 x 768; four rows a block too:
// PERF.md.)  Wider rows take a 512-thread block a row and the column
// pass.
//
// RMSNorm backward: the same kernels with kMean = false.  Replaces
// apex_example_tpu/ops/layer_norm.py:285 `_rms_bwd_kernel` (launched by
// `_norm_bwd_pallas` with mean None, :161 / :192).  Same arithmetic
// (:285-294): x_hat = x * rstd, wdy = dy * gamma, c2 = mean(wdy * x_hat),
// dx = rstd * (wdy - x_hat * c2) in x's dtype, dgamma = sum over rows of
// dy * x_hat in fp32; no c1 and no dbeta.  Bound: bytes, 3*N*H elements
// (x, dy read; dx written) + 4*H + 4*N, plus the workspace, now one
// [n_groups, H] plane (4096 x 768 fp32: 37.8 MB, ~11.3 us without it).
// The Pallas kernel adds dgamma across grid steps that run in order
// (:292); here the per-group partials and the fixed-order column pass
// again, so dgamma repeats bitwise.

constexpr int kBwdColTile = 32;     // columns per block of the column sum
constexpr int kBwdColSegs = 16;     // workspace-row segments per block
constexpr int kFewWarps = 8;        // rows a block of ln_bwd_rows_kernel

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

// kMean: LayerNorm.  Without it RMSNorm: mean_in and ws_db are null.
template <typename T, int VEC, int TPR, int CHUNKS, bool kMean>
__global__ void __launch_bounds__(TPR == 32 ? 128 : TPR)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma,
                  const float* __restrict__ mean_in,
                  const float* __restrict__ rstd_in, T* __restrict__ dx,
                  float* __restrict__ ws_dg, float* __restrict__ ws_db,
                  int64_t n_rows, int h, int64_t n_groups) {
  __shared__ float smem[32];
  constexpr int kGroupsPerBlock = TPR == 32 ? 4 : 1;
  const int tid = TPR == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const int64_t group = static_cast<int64_t>(blockIdx.x) * kGroupsPerBlock +
                        (TPR == 32 ? (threadIdx.x >> 5) : 0);
  // A whole row group leaves together (see ln_fwd_kernel).
  if (group >= n_groups) return;

  float pg[CHUNKS][VEC], pb[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) pg[c][i] = pb[c][i] = 0.f;
  for (int64_t row = group; row < n_rows; row += n_groups)
    bwd_row<T, VEC, TPR, CHUNKS, kMean>(x, dy, gamma, mean_in, rstd_in, dx,
                                        row, h, tid, smem, pg, pb);

  float* wg = ws_dg + group * h;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * TPR + tid) * VEC;
    if (col < h) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        wg[col + i] = pg[c][i];
        if constexpr (kMean) ws_db[group * h + col + i] = pb[c][i];
      }
    }
  }
}

// Few rows, each its own group, in the warp layout: one launch.  Warp w of
// block k takes row kFewWarps k + w (dx as ln_bwd_kernel's rows); the block
// adds its rows' dy * x_hat (and dy) per column in row order through
// shared memory into workspace row k; the last block to finish, told by
// an integer ticket behind __threadfence, adds the workspace rows per
// column in order into dgamma (and dbeta) and sets the ticket back to 0
// for the next launch.  No float atomics: the sums repeat bitwise.
template <typename T, int VEC, bool kMean>
__global__ void __launch_bounds__(kFewWarps * 32, 1) ln_bwd_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ gamma, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, T* __restrict__ dx,
    float* __restrict__ ws_dg, float* __restrict__ ws_db,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    unsigned int* ticket, int64_t n_rows, int h) {
  constexpr int kChunks = kWarpElems / VEC;
  constexpr int kThreads = kFewWarps * 32;
  __shared__ float part[kFewWarps][kWarpElems * 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kFewWarps + warp;
  float pg[kChunks][VEC], pb[kChunks][VEC];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) pg[c][i] = pb[c][i] = 0.f;
  if (row < n_rows)
    bwd_row<T, VEC, 32, kChunks, kMean>(x, dy, gamma, mean_in, rstd_in, dx,
                                        row, h, lane, nullptr, pg, pb);

  for (int pass = 0; pass < (kMean ? 2 : 1); ++pass) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        part[warp][(c * 32 + lane) * VEC + i] = pass ? pb[c][i] : pg[c][i];
    __syncthreads();
    float* ws = (pass ? ws_db : ws_dg) + blockIdx.x * static_cast<int64_t>(h);
    for (int col = threadIdx.x; col < h; col += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kFewWarps; ++w) s += part[w][col];
      ws[col] = s;
    }
    __syncthreads();  // part is written again by the next pass
  }
  __threadfence();  // this block's workspace row before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int col = threadIdx.x; col < h; col += kThreads) {
    float s = 0.f, t = 0.f;
    for (unsigned k = 0; k < gridDim.x; ++k) {
      s += __ldcg(ws_dg + k * static_cast<int64_t>(h) + col);
      if (kMean) t += __ldcg(ws_db + k * static_cast<int64_t>(h) + col);
    }
    dgamma[col] = s;
    if (kMean) dbeta[col] = t;
  }
  if (threadIdx.x == 0) *ticket = 0u;
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

// A group a row (n_groups == n) in the warp layout takes the one-launch
// ln_bwd_rows_kernel, which needs the ticket; anything else ln_bwd_kernel
// and the column pass.
template <typename T, int VEC, bool kMean>
int launch_bwd(const void* x, const void* dy, const float* gamma,
               const float* mean, const float* rstd, void* dx, float* dgamma,
               float* dbeta, float* ws, unsigned int* ticket, int64_t n,
               int h, int64_t n_groups, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  float* ws_dg = ws;
  float* ws_db = kMean ? ws + n_groups * h : nullptr;
  constexpr int kChunks = kWarpElems / VEC;
  if (h <= kChunks * 32 * VEC && n_groups == n && ticket != nullptr) {
    ln_bwd_rows_kernel<T, VEC, kMean>
        <<<static_cast<unsigned>((n + kFewWarps - 1) / kFewWarps),
           kFewWarps * 32, 0, stream>>>(xt, dyt, gamma, mean, rstd, dxt,
                                        ws_dg, ws_db, dgamma, dbeta, ticket,
                                        n, h);
    return static_cast<int>(cudaGetLastError());
  }
  if (h <= kChunks * 32 * VEC) {
    ln_bwd_kernel<T, VEC, 32, kChunks, kMean>
        <<<static_cast<unsigned>((n_groups + 3) / 4), 128, 0, stream>>>(
            xt, dyt, gamma, mean, rstd, dxt, ws_dg, ws_db, n, h, n_groups);
  } else {
    ln_bwd_kernel<T, VEC, kBlockThreads, kMaxH / (kBlockThreads * VEC), kMean>
        <<<static_cast<unsigned>(n_groups), kBlockThreads, 0, stream>>>(
            xt, dyt, gamma, mean, rstd, dxt, ws_dg, ws_db, n, h, n_groups);
  }
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const unsigned col_blocks =
      static_cast<unsigned>((h + kBwdColTile - 1) / kBwdColTile);
  ln_bwd_colsum_kernel<kMean>
      <<<col_blocks, dim3(kBwdColTile, kBwdColSegs), 0, stream>>>(
          ws_dg, ws_db, dgamma, dbeta, h, n_groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kMean>
int dispatch_bwd(const void* x, const void* dy, const float* gamma,
                 const float* mean, const float* rstd, void* dx,
                 float* dgamma, float* dbeta, float* ws, unsigned int* ticket,
                 int64_t n, int h, int64_t n_groups, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = h % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (vec)
    return launch_bwd<T, kVec, kMean>(x, dy, gamma, mean, rstd, dx, dgamma,
                                      dbeta, ws, ticket, n, h, n_groups,
                                      stream);
  return launch_bwd<T, 1, kMean>(x, dy, gamma, mean, rstd, dx, dgamma, dbeta,
                                 ws, ticket, n, h, n_groups, stream);
}

}  // namespace

// Backward.  dx in x's dtype (dy has it too); dgamma, dbeta fp32 (H,);
// workspace 2 * n_groups * H floats of scratch; ticket one uint32 that is 0
// at the launch and is 0 again after it (null: never the one-launch
// kernel).  Argument errors are negative; a launch error is the
// cudaError_t value.
extern "C" int apex_layer_norm_bwd(const void* x, const void* dy,
                                   const void* gamma, const void* mean,
                                   const void* rstd, void* dx, void* dgamma,
                                   void* dbeta, void* workspace, void* ticket,
                                   long long n_rows, int h,
                                   long long n_groups, int dtype,
                                   void* stream) {
  if (h < 1 || h > kMaxH) return -2;
  if (n_rows < 1 || n_rows > 0x7fffffffLL) return -3;
  if (n_groups < 1 || n_groups > n_rows) return -4;
  const float* g = static_cast<const float*>(gamma);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* ws = static_cast<float*>(workspace);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_bwd<float, true>(x, dy, g, m, r, dx, dg, db, ws, tk,
                                       n_rows, h, n_groups, s);
    case 1:
      return dispatch_bwd<__nv_bfloat16, true>(x, dy, g, m, r, dx, dg, db, ws,
                                               tk, n_rows, h, n_groups, s);
    case 2:
      return dispatch_bwd<__half, true>(x, dy, g, m, r, dx, dg, db, ws, tk,
                                        n_rows, h, n_groups, s);
    default:
      return -1;
  }
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

// RMSNorm backward: dx in x's dtype (dy has it too), dgamma fp32 (H,);
// workspace n_groups * H floats of scratch; the ticket as LayerNorm's.
// Argument errors are negative; a launch error is the cudaError_t value.
extern "C" int apex_rms_norm_bwd(const void* x, const void* dy,
                                 const void* gamma, const void* rstd,
                                 void* dx, void* dgamma, void* workspace,
                                 void* ticket, long long n_rows, int h,
                                 long long n_groups, int dtype,
                                 void* stream) {
  if (h < 1 || h > kMaxH) return -2;
  if (n_rows < 1 || n_rows > 0x7fffffffLL) return -3;
  if (n_groups < 1 || n_groups > n_rows) return -4;
  const float* g = static_cast<const float*>(gamma);
  const float* r = static_cast<const float*>(rstd);
  float* dg = static_cast<float*>(dgamma);
  float* ws = static_cast<float*>(workspace);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_bwd<float, false>(x, dy, g, nullptr, r, dx, dg, nullptr,
                                        ws, tk, n_rows, h, n_groups, s);
    case 1:
      return dispatch_bwd<__nv_bfloat16, false>(x, dy, g, nullptr, r, dx, dg,
                                                nullptr, ws, tk, n_rows, h,
                                                n_groups, s);
    case 2:
      return dispatch_bwd<__half, false>(x, dy, g, nullptr, r, dx, dg,
                                         nullptr, ws, tk, n_rows, h, n_groups,
                                         s);
    default:
      return -1;
  }
}

extern "C" int apex_layer_norm_max_h() { return kMaxH; }

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
