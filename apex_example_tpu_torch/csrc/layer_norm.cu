// LayerNorm forward for Hopper (sm_90a), bound to Python with ctypes.
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
// registers (16-byte vector loads where H and the pointers allow, a scalar
// path otherwise, e.g. for odd H), both reductions and the normalisation
// read the registers, and nothing but y, mean and rstd is stored.
//
// Layout: a row group of TPR threads owns one row.  Rows of up to
// kWarpChunks * 32 * VEC elements take one warp each (TPR = 32, four rows
// in a 128-thread block) and reduce with warp shuffles alone; wider rows,
// up to kMaxH, take a 512-thread block each and reduce across its warps
// through shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxH = 8192;
constexpr int kWarpChunks = 8;
constexpr int kBlockThreads = 512;

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

template <typename T, int VEC, int TPR, int CHUNKS>
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

  float v[CHUNKS][VEC];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * TPR + tid) * VEC;
    if (col < h) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + col);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c][i] = to_float(p.v[i]);
        sum += v[c][i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[c][i] = 0.f;
    }
  }
  const float fh = static_cast<float>(h);
  const float mean = group_sum<TPR>(sum, smem) / fh;

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
  const float rstd = rsqrtf(group_sum<TPR>(sq, smem) / fh + eps);

#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * TPR + tid) * VEC;
    if (col < h) {
      Pack<T, VEC> p;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        p.v[i] = from_float<T>((v[c][i] - mean) * rstd * gamma[col + i] +
                               beta[col + i]);
      *reinterpret_cast<Pack<T, VEC>*>(yr + col) = p;
    }
  }
  if (tid == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int VEC>
int launch(const void* x, const float* gamma, const float* beta, void* y,
           float* mean, float* rstd, int64_t n, int h, float eps,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (h <= kWarpChunks * 32 * VEC) {
    const int64_t blocks = (n + 3) / 4;
    ln_fwd_kernel<T, VEC, 32, kWarpChunks>
        <<<static_cast<unsigned>(blocks), 128, 0, stream>>>(
            xt, gamma, beta, yt, mean, rstd, n, h, eps);
  } else {
    ln_fwd_kernel<T, VEC, kBlockThreads, kMaxH / (kBlockThreads * VEC)>
        <<<static_cast<unsigned>(n), kBlockThreads, 0, stream>>>(
            xt, gamma, beta, yt, mean, rstd, n, h, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* gamma, const float* beta, void* y,
             float* mean, float* rstd, int64_t n, int h, float eps,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = h % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec)
    return launch<T, kVec>(x, gamma, beta, y, mean, rstd, n, h, eps, stream);
  return launch<T, 1>(x, gamma, beta, y, mean, rstd, n, h, eps, stream);
}

}  // namespace

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
      return dispatch<float>(x, g, b, y, m, r, n_rows, h, eps, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, g, b, y, m, r, n_rows, h, eps, s);
    case 2:
      return dispatch<__half>(x, g, b, y, m, r, n_rows, h, eps, s);
    default:
      return -1;
  }
}

extern "C" int apex_layer_norm_max_h() { return kMaxH; }

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
