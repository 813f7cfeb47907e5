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
// Design: one launch of a persistent, balanced grid.
// - Tiles.  A block's 256 threads form TY rows of TX channel groups of V
//   neighbouring channels (V = 4 with one 16-byte fp32 or 8-byte half load
//   where C is a multiple of 4 and the rows are aligned, else V = 1), so a
//   warp reads neighbouring channels of a row, coalesced.  The grid is
//   channel slabs (TX * V channels each) by row blocks.
// - Balance.  The grid holds SMs x resident blocks of this kernel (the
//   occupancy on this device: ops/batch_norm.py `geometry`), so every block
//   is resident at once, and each row block takes an equal contiguous share
//   of the block rows (`share`; the shares differ by one block row at
//   most): every SM streams the same bytes and all finish together.
// - One launch.  A thread accumulates its rows in registers; the block adds
//   its TY rows in shared memory in a fixed order and writes one row of
//   per-block partials [row_block, 2, C].  The last block of each slab to
//   finish, told by an integer ticket behind __threadfence, adds the slab's
//   partial rows in a fixed order and sets the ticket back to 0 for the next
//   launch.  No float atomics: two calls on the same inputs give
//   bitwise-identical sums on one card (the grid follows its SM count).
// - Read-once loads.  x and dy are read once, with no L1 line allocated
//   (`ld.global.nc.L1::no_allocate`).  At 3,211,264 x 64 they beat plain
//   loads (`tools/norm_bwd_times.py --bn-loads plain` builds and times
//   that variant; PERF.md has both).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // block rows a thread loads before it adds

enum Mode { kStats = 0, kBwd = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <int B>
struct Bytes;  // B bytes as one load
template <>
struct Bytes<16> {
  using type = uint4;
};
template <>
struct Bytes<8> {
  using type = uint2;
};
template <>
struct Bytes<4> {
  using type = unsigned int;
};
template <>
struct Bytes<2> {
  using type = unsigned short;
};

// B bytes at p, read once: no L1 line is allocated for them.
template <int B>
__device__ __forceinline__ typename Bytes<B>::type load_once(const void* p) {
  typename Bytes<B>::type r;
  if constexpr (B == 16)
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
  else if constexpr (B == 8)
    asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
        : "=r"(r.x), "=r"(r.y)
        : "l"(p));
  else if constexpr (B == 4)
    asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];"
        : "=r"(r)
        : "l"(p));
  else
    asm("ld.global.nc.L1::no_allocate.L2::256B.u16 %0, [%1];"
        : "=h"(r)
        : "l"(p));
  return r;
}

// V neighbouring elements of one row as floats, one load (the caller has
// checked the alignment for V = 4).
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* p, float (&out)[V]) {
  const auto raw = load_once<V * static_cast<int>(sizeof(T))>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < V; ++u) out[u] = to_float(e[u]);
}

// Adds row values xv (and gv) of V channels into the sums: kStats (x - a)
// and its square; kBwd dy and dy * (x - a) * b.
template <int V, int MODE>
__device__ __forceinline__ void add_row(const float (&xv)[V],
                                        const float (&gv)[V],
                                        const float (&av)[V],
                                        const float (&bv)[V], float (&s1)[V],
                                        float (&s2)[V]) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    if constexpr (MODE == kStats) {
      const float d = xv[u] - av[u];
      s1[u] += d;
      s2[u] += d * d;
    } else {
      const float xh = (xv[u] - av[u]) * bv[u];
      s1[u] += gv[u];
      s2[u] += gv[u] * xh;
    }
  }
}

// Rows [r0, r1) of row block rb of n_rb: block rows [rb * k / n_rb,
// (rb + 1) * k / n_rb) of the k block rows (chunk rows each).  The shares
// differ by one block row at most and the last is a long one, so the short
// last block row falls in a long share.
__device__ __forceinline__ void share(long long rows, int chunk, long long rb,
                                      long long n_rb, long long& r0,
                                      long long& r1) {
  const long long chunks = (rows + chunk - 1) / chunk;
  r0 = rb * chunks / n_rb * chunk;
  const long long end = (rb + 1) * chunks / n_rb * chunk;
  r1 = end < rows ? end : rows;
}

// Column sums over the rows of row block blockIdx.y's share, for the
// channels of slab blockIdx.x, into partial[(rb * 2 + k) * C + c]; then,
// in the slab's last block, over the row blocks into out[k * C + c].
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads)
    bn_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ a, const float* __restrict__ b,
                   long long rows, int C, int tx_n,
                   float* __restrict__ partial, float* __restrict__ out,
                   unsigned int* __restrict__ tickets) {
  __shared__ float smem[2 * kThreads * V];
  __shared__ bool last;
  const int ty_n = kThreads / tx_n;
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int slab = tx_n * V;
  const int c0 = blockIdx.x * slab + tx * V;
  long long r0, r1;
  share(rows, ty_n, blockIdx.y, gridDim.y, r0, r1);
  const int step = kUnroll * ty_n;  // rows a pass of the block takes

  float s1[V], s2[V], av[V], bv[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    s1[u] = 0.f;
    s2[u] = 0.f;
    av[u] = 0.f;
    bv[u] = 0.f;
  }
  if (c0 < C) {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (c0 + u < C) {
        av[u] = a[c0 + u];
        if constexpr (MODE == kBwd) bv[u] = b[c0 + u];
      }
    }
  }
  if (c0 < C) {
    // V = 1 takes any C; V = 4 needs C % 4 == 0, so c0 < C covers all four.
    for (long long r = r0 + ty; r < r1; r += step) {
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
      for (int k = 0; k < kUnroll; ++k)
        if (r + static_cast<long long>(k) * ty_n < r1)
          add_row<V, MODE>(xv[k], gv[k], av, bv, s1, s2);
    }
  }

  // smem[(k * ty_n + ty) * slab + tx * V + u]: the block's TY rows of sums,
  // added per (output, channel of the slab) in row order.
#pragma unroll
  for (int u = 0; u < V; ++u) {
    smem[ty * slab + tx * V + u] = s1[u];
    smem[(ty_n + ty) * slab + tx * V + u] = s2[u];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * slab; j += kThreads) {
    const int k = j / slab;
    const int cj = j % slab;
    float acc = 0.f;
    for (int t = 0; t < ty_n; ++t) acc += smem[(k * ty_n + t) * slab + cj];
    const int c = blockIdx.x * slab + cj;
    if (c < C)
      partial[(static_cast<long long>(blockIdx.y) * 2 + k) * C + c] = acc;
  }

  __threadfence();  // this block's partial row before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The slab's 2 * slab sums as nq groups of V columns; segment g of the
  // block adds partial rows g, g + nseg, ..., then the segments are added
  // in order 0..nseg-1.
  const int nq = 2 * slab / V;  // a power of two, at most 64
  const int nseg = kThreads / nq;
  const int q = threadIdx.x % nq, g = threadIdx.x / nq;
  const int k = q / (nq / 2);
  const int c = blockIdx.x * slab + (q % (nq / 2)) * V;
  float acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = 0.f;
  if (c < C) {
    for (unsigned r = g; r < gridDim.y; r += nseg) {
      const float* p = partial + (static_cast<long long>(r) * 2 + k) * C + c;
      if constexpr (V == 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
        acc[0] += v.x, acc[1] += v.y, acc[2] += v.z, acc[3] += v.w;
      } else {
        acc[0] += __ldcg(p);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < V; ++u) smem[g * 2 * slab + q * V + u] = acc[u];
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * slab; j += kThreads) {
    float s = 0.f;
    for (int t = 0; t < nseg; ++t) s += smem[t * 2 * slab + j];
    const int cj = blockIdx.x * slab + j % slab;
    if (cj < C) out[(j / slab) * C + cj] = s;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

// The kernel of this dtype and vec (4 or 1) for op.
template <typename Op>
int by_dtype(const Op& op, int dtype, int vec) {
  switch (dtype * 2 + (vec == 4)) {
    case 0:
      return op.template run<float, 1>();
    case 1:
      return op.template run<float, 4>();
    case 2:
      return op.template run<__nv_bfloat16, 1>();
    case 3:
      return op.template run<__nv_bfloat16, 4>();
    case 4:
      return op.template run<__half, 1>();
    case 5:
      return op.template run<__half, 4>();
    default:
      return -1;
  }
}

bool valid(long long rows, int C, int vec, int tx_n) {
  return rows >= 1 && C >= 1 && tx_n >= 1 && tx_n <= 32 &&
         (tx_n & (tx_n - 1)) == 0 && (vec == 1 || (vec == 4 && C % 4 == 0));
}

template <int MODE>
struct Launch {
  const void *x, *dy;
  const float *a, *b;
  long long rows;
  int C, tx_n, n_rb;
  float *partial, *out;
  unsigned int* tickets;
  cudaStream_t stream;

  template <typename T, int V>
  int run() const {
    const int slab = tx_n * V;
    const dim3 grid(static_cast<unsigned>((C + slab - 1) / slab),
                    static_cast<unsigned>(n_rb));
    bn_sums_kernel<T, V, MODE><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), a, b, rows, C,
        tx_n, partial, out, tickets);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int MODE>
struct Resident {
  int* blocks;

  template <typename T, int V>
  int run() const {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, bn_sums_kernel<T, V, MODE>, kThreads, 0));
  }
};

template <int MODE>
int run(const void* x, const void* dy, const float* a, const float* b,
        long long rows, int C, int dtype, int vec, int tx_n, int n_rb,
        float* partial, float* out, unsigned int* tickets,
        cudaStream_t stream) {
  if (!valid(rows, C, vec, tx_n) || n_rb < 1 || n_rb > 65535) return -2;
  const Launch<MODE> op{x,    dy,      a,   b,       rows,  C,
                        tx_n, n_rb,    partial, out, tickets, stream};
  return by_dtype(op, dtype, vec);
}

}  // namespace

// x: (rows, C) of dtype `dtype`, C contiguous; c: C floats.  Launch
// geometry from the caller (ops/batch_norm.py `geometry`): vec channels per
// thread, tx_n channel groups per block row, n_rb row blocks.  partial:
// n_rb * 2C floats of scratch; tickets: one uint32 per channel slab, 0 at
// the launch and 0 again after it.  out: 2C floats, sum(x - c) then
// sum((x - c)^2).  Argument errors are negative; a launch error is the
// cudaError_t value.
extern "C" int apex_bn_stats(const void* x, const void* c, long long rows,
                             int C, int dtype, int vec, int tx_n, int n_rb,
                             void* partial, void* out, void* tickets,
                             void* stream) {
  return run<kStats>(x, nullptr, static_cast<const float*>(c), nullptr, rows,
                     C, dtype, vec, tx_n, n_rb, static_cast<float*>(partial),
                     static_cast<float*>(out),
                     static_cast<unsigned int*>(tickets),
                     static_cast<cudaStream_t>(stream));
}

// x, dy: (rows, C) of dtype `dtype`; mean, inv: C floats.  out: 2C floats,
// sum(dy) then sum(dy * (x - mean) * inv).  The rest as apex_bn_stats.
extern "C" int apex_bn_bwd_sums(const void* x, const void* dy,
                                const void* mean, const void* inv,
                                long long rows, int C, int dtype, int vec,
                                int tx_n, int n_rb, void* partial, void* out,
                                void* tickets, void* stream) {
  return run<kBwd>(x, dy, static_cast<const float*>(mean),
                   static_cast<const float*>(inv), rows, C, dtype, vec, tx_n,
                   n_rb, static_cast<float*>(partial),
                   static_cast<float*>(out),
                   static_cast<unsigned int*>(tickets),
                   static_cast<cudaStream_t>(stream));
}

// *blocks: how many blocks of the kernel for this dtype and vec (mode 0
// the stats, 1 the backward sums) are resident on one SM of the current
// device.  Errors as above.
extern "C" int apex_bn_resident(int mode, int dtype, int vec, int* blocks) {
  if (vec != 1 && vec != 4) return -2;
  if (mode == kStats) return by_dtype(Resident<kStats>{blocks}, dtype, vec);
  if (mode == kBwd) return by_dtype(Resident<kBwd>{blocks}, dtype, vec);
  return -1;
}

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
