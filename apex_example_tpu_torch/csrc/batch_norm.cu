// BatchNorm statistics and backward sums for Hopper (sm_90a), bound with
// ctypes.
//
// Replace apex_example_tpu/ops/batch_norm.py:74 `_stats_kernel` (launched by
// `bn_stats`, :103 / :117) and :88 `_bwd_sums_kernel` (`bn_bwd_sums`, :128 /
// :145).  Over a (rows, C) view of channels-last activations, per channel:
//
//   stats:     s = sum(x - c),  ss = sum((x - c)^2)     c: the running mean
//   bwd sums:  sdy = sum(dy),   sdyx = sum(dy * x_hat), x_hat = (x - mean)*inv
//
// in fp32 whatever x's and dy's dtype (fp32, bf16 or fp16).  The TPU kernels
// carry the sums in their output blocks from one grid step to the next,
// which run in order there, and need the rows to tile by 8; here blocks run
// concurrently, in no order, and any row count and any C is taken.
//
// Bound: bytes.  The stats read x once, the sums x and dy once, and each
// writes 2C floats; a few operations per element.  At ResNet-50's stem at
// batch 256 (3,211,264 x 64 fp32), x alone is 822 MB: ~0.245 ms at
// 3.35 TB/s.
//
// Design.  One launch of blocks of 256 threads tiles rows x channel slabs:
// a block's threads form TY rows of TX channel groups of V neighbouring
// channels (V = 4 with one 16-byte fp32 or 8-byte half load where C is a
// multiple of 4 and the rows are aligned, else V = 1), so a warp reads
// neighbouring channels of a row, coalesced.  Each thread walks its rows
// of the block's row range, accumulating in registers; the block adds its
// TY rows of sums in shared memory in a fixed order and writes one row of
// per-block partials [row_block, 2, C].  A second launch of the same kernel
// adds those partials over the row blocks, in a fixed order.  No float
// atomics: two calls on the same inputs give bitwise-identical sums.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // rows a thread loads before it adds them

enum Mode { kStats = 0, kBwd = 1, kSum = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// V neighbouring elements of one row as floats: one 16-byte (fp32) or
// 8-byte (half) load for V = 4, the caller having checked the alignment.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* p, float (&out)[V]) {
  if constexpr (V == 4) {
    if constexpr (sizeof(T) == 4) {
      const float4 raw = *reinterpret_cast<const float4*>(p);
      out[0] = raw.x;
      out[1] = raw.y;
      out[2] = raw.z;
      out[3] = raw.w;
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < 4; ++u) out[u] = to_float(e[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = to_float(p[u]);
  }
}

// Column sums over rows [r0, r1) of a (rows, C) matrix, for the channels of
// slab blockIdx.x; blockIdx.y is the row block.  kStats: (x - a) and its
// square; kBwd: dy and dy * (x - a) * b; kSum: x alone (the partials of the
// first two modes, then C is 2 C' and there is one output).  out holds
// NOUT rows of C floats per row block: out[(rb * NOUT + k) * C + c].
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads)
    colsum_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ a, const float* __restrict__ b,
                  long long rows, int C, long long rows_per_block, int tx_n,
                  float* __restrict__ out) {
  constexpr int NOUT = MODE == kSum ? 1 : 2;
  __shared__ float smem[NOUT * kThreads * V];
  const int ty_n = kThreads / tx_n;
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int slab = tx_n * V;
  const int c0 = blockIdx.x * slab + tx * V;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_block;
  long long r1 = r0 + rows_per_block;
  if (r1 > rows) r1 = rows;

  float s1[V], s2[V], av[V], bv[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    s1[u] = 0.f;
    s2[u] = 0.f;
    av[u] = 0.f;
    bv[u] = 0.f;
  }
  if (c0 < C) {
    if constexpr (MODE != kSum) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (c0 + u < C) {
          av[u] = a[c0 + u];
          if constexpr (MODE == kBwd) bv[u] = b[c0 + u];
        }
      }
    }
    // V = 1 takes any C; V = 4 needs C % 4 == 0, so c0 < C covers all four.
    for (long long r = r0 + ty; r < r1; r += kUnroll * ty_n) {
      float xv[kUnroll][V], gv[kUnroll][V];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long rk = r + static_cast<long long>(k) * ty_n;
        if (rk < r1) {
          load_row<T, V>(x + rk * C + c0, xv[k]);
          if constexpr (MODE == kBwd) load_row<T, V>(dy + rk * C + c0, gv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long rk = r + static_cast<long long>(k) * ty_n;
        if (rk < r1) {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            if constexpr (MODE == kStats) {
              const float d = xv[k][u] - av[u];
              s1[u] += d;
              s2[u] += d * d;
            } else if constexpr (MODE == kBwd) {
              const float xh = (xv[k][u] - av[u]) * bv[u];
              s1[u] += gv[k][u];
              s2[u] += gv[k][u] * xh;
            } else {
              s1[u] += xv[k][u];
            }
          }
        }
      }
    }
  }
  // smem[(k * ty_n + ty) * slab + tx * V + u]
#pragma unroll
  for (int u = 0; u < V; ++u) {
    smem[ty * slab + tx * V + u] = s1[u];
    if constexpr (NOUT == 2) smem[(ty_n + ty) * slab + tx * V + u] = s2[u];
  }
  __syncthreads();
  // One thread per (output, channel of the slab) adds the TY rows in order.
  for (int j = threadIdx.x; j < NOUT * slab; j += kThreads) {
    const int k = j / slab;
    const int cj = j % slab;
    float acc = 0.f;
    for (int t = 0; t < ty_n; ++t) acc += smem[(k * ty_n + t) * slab + cj];
    const int c = blockIdx.x * slab + cj;
    if (c < C)
      out[(static_cast<long long>(blockIdx.y) * NOUT + k) * C + c] = acc;
  }
}

template <typename T, int V, int MODE>
int launch_colsum(const void* x, const void* dy, const float* a,
                  const float* b, long long rows, int C, int tx_n, int n_rb,
                  float* out, cudaStream_t stream) {
  const int slab = tx_n * V;
  const dim3 grid(static_cast<unsigned>((C + slab - 1) / slab),
                  static_cast<unsigned>(n_rb));
  const long long rpb = (rows + n_rb - 1) / n_rb;
  colsum_kernel<T, V, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), a, b, rows, C,
      rpb, tx_n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int first_pass(const void* x, const void* dy, const float* a, const float* b,
               long long rows, int C, int vec, int tx_n, int n_rb,
               float* partial, cudaStream_t stream) {
  if (vec == 4)
    return launch_colsum<T, 4, MODE>(x, dy, a, b, rows, C, tx_n, n_rb,
                                     partial, stream);
  return launch_colsum<T, 1, MODE>(x, dy, a, b, rows, C, tx_n, n_rb, partial,
                                   stream);
}

// The second pass: sums over the n_rb rows of partial [n_rb, 2C] into
// out [2C], one row block; the row length 2C is a multiple of 2 only, so
// V = 4 where C is even (then 2C % 4 == 0), else V = 1.
int second_pass(const float* partial, int C, int n_rb, int tx2_n,
                float* out, cudaStream_t stream) {
  if ((2 * C) % 4 == 0)
    return launch_colsum<float, 4, kSum>(partial, nullptr, nullptr, nullptr,
                                         n_rb, 2 * C, tx2_n, 1, out, stream);
  return launch_colsum<float, 1, kSum>(partial, nullptr, nullptr, nullptr,
                                       n_rb, 2 * C, tx2_n, 1, out, stream);
}

bool valid_tx(int tx_n) {
  return tx_n >= 1 && tx_n <= 32 && (tx_n & (tx_n - 1)) == 0;
}

template <int MODE>
int run(const void* x, const void* dy, const float* a, const float* b,
        long long rows, int C, int dtype, int vec, int tx_n, int n_rb,
        int tx2_n, float* partial, float* out, cudaStream_t stream) {
  if (rows < 1 || C < 1 || n_rb < 1 || n_rb > 65535 || !valid_tx(tx_n) ||
      !valid_tx(tx2_n) || (vec != 1 && vec != 4) ||
      (vec == 4 && C % 4 != 0))
    return -2;
  int rc;
  switch (dtype) {
    case 0:
      rc = first_pass<float, MODE>(x, dy, a, b, rows, C, vec, tx_n, n_rb,
                                   partial, stream);
      break;
    case 1:
      rc = first_pass<__nv_bfloat16, MODE>(x, dy, a, b, rows, C, vec, tx_n,
                                           n_rb, partial, stream);
      break;
    case 2:
      rc = first_pass<__half, MODE>(x, dy, a, b, rows, C, vec, tx_n, n_rb,
                                    partial, stream);
      break;
    default:
      return -1;
  }
  if (rc != 0) return rc;
  return second_pass(partial, C, n_rb, tx2_n, out, stream);
}

}  // namespace

// x: (rows, C) of dtype `dtype`, C contiguous; c: C floats.  Launch
// geometry from the caller (ops/batch_norm.py): vec channels per thread,
// tx_n channel groups per block row, n_rb row blocks; tx2_n the channel
// groups of the second pass.  partial: n_rb * 2C floats of scratch.  out:
// 2C floats, sum(x - c) then sum((x - c)^2).  Argument errors are negative;
// a launch error is the cudaError_t value.
extern "C" int apex_bn_stats(const void* x, const void* c, long long rows,
                             int C, int dtype, int vec, int tx_n, int n_rb,
                             int tx2_n, void* partial, void* out,
                             void* stream) {
  return run<kStats>(x, nullptr, static_cast<const float*>(c), nullptr, rows,
                     C, dtype, vec, tx_n, n_rb, tx2_n,
                     static_cast<float*>(partial), static_cast<float*>(out),
                     static_cast<cudaStream_t>(stream));
}

// x, dy: (rows, C) of dtype `dtype`; mean, inv: C floats.  out: 2C floats,
// sum(dy) then sum(dy * (x - mean) * inv).  The rest as apex_bn_stats.
extern "C" int apex_bn_bwd_sums(const void* x, const void* dy,
                                const void* mean, const void* inv,
                                long long rows, int C, int dtype, int vec,
                                int tx_n, int n_rb, int tx2_n, void* partial,
                                void* out, void* stream) {
  return run<kBwd>(x, dy, static_cast<const float*>(mean),
                   static_cast<const float*>(inv), rows, C, dtype, vec, tx_n,
                   n_rb, tx2_n, static_cast<float*>(partial),
                   static_cast<float*>(out),
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
