// Flash attention for Hopper (sm_90a): the forward, the dK/dV backward and
// the dQ backward, bound to Python with ctypes.
//
// Replaces the three Pallas kernels of apex_example_tpu/ops/attention.py:
//   attn_fwd   <- :147 `_fwd_kernel`   (launched by `_attn_fwd_pallas` :309)
//   attn_dkdv  <- :183 `_dkdv_kernel`  (launched by `_attn_bwd_pallas` :343)
//   attn_dq    <- :216 `_dq_kernel`    (the same call site, :390)
// Same arithmetic.  Scores S = (Q K^T) * scale, then + bias (an additive
// fp32 key bias of shape (B, Sk)), then the causal mask, bottom-right
// aligned (query i sees keys 0 .. i + Sk - Sq), written as JAX's finite
// _MASK = -0.7 * FLT_MAX.  The forward keeps the running row max m, row sum
// l and the unnormalised P V in fp32, rounds P to the input dtype before
// P V (:170), and writes O = acc / l in the input dtype and the row
// logsumexp m + log l in fp32, with l = 0 taken as 1 (`lsafe`).  The
// backward recomputes P = exp(S - lse) and takes the precomputed
// Delta = rowsum(dO * O) - dlse (left to PyTorch, as JAX leaves it to
// XLA): dV += P^T dO with P rounded to the input dtype, dP = dO V^T,
// dS = P * (dP - Delta) * scale rounded to the input dtype, dK += dS^T Q,
// dQ += dS K.  dQ and dK/dV are separate kernels, as in JAX: no kernel
// adds into another block's output, so every result repeats bitwise.
//
// Inputs fp32, bf16 or fp16; every product and sum in fp32.  Products run
// as fp32 fused multiply-adds on the CUDA cores, not on the tensor cores:
// fp32 without TF32 (the port's fp32 contract), and bf16 / fp16 operands
// widen exactly to fp32, so the products are those of JAX's
// `preferred_element_type=float32` dots.
//
// Bound: operations.  Each live score costs 4 (forward), 8 (dK/dV) and 6
// (dQ) flops per head-dimension element, and the bytes are O(S * D) per
// head, so at gpt_base's 8 x 2048 x 12 x 64 the least time is the flops
// over the card's fp32 rate (bf16: its tensor-core rate).  The design is
// the simple one: tiles of 64 queries and 64 keys in shared memory, held
// as fp32; 256 threads, each owning a 4 x 4 piece of the score tile (4
// rows, columns 16 apart) and 4 rows x 8 head-dim columns of the output;
// 16-byte shared-memory loads along the head dimension; row maxima and sums
// over the 16 threads of a row with warp shuffles.  Causal tiles wholly
// above the diagonal are skipped, as `_when_live` (:121) skips them.
// Tensor-core (wgmma) and TMA pipelines are for a later change.
//
// Layout: q, k, v, o and dO are read in their (B, S, H, D) layout through
// four strides each (elements), so no transpose is copied; O, dQ, dK and
// dV are written contiguous (B, S, H, D); lse and Delta are contiguous
// (B, H, Sq) fp32.  Any Sq, Sk (tail tiles masked); D a multiple of 8 up
// to kMaxD.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // queries of a q tile, keys of a k/v tile
constexpr int kThreads = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr int kMaxD = 128;
constexpr int kLdS = kTile + 4;  // row stride of a score tile in smem
constexpr float kMask = -0.7f * 3.402823466e38f;  // attention.py:60

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

// v rounded to T and widened back: where the Pallas bodies cast P or dS
// to the input dtype before a product.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;   // (B, Sk) or null
  const float* lse;    // (B, H, Sq), read by the backward
  const float* delta;  // (B, H, Sq), read by the backward
  void* out;           // O (forward) or dQ
  float* lse_out;      // forward
  void* dk;
  void* dv;
  long long sq[4], sk[4], sv[4], sdo[4];  // strides of (B, S, H, D)
  long long sbias[2];                     // strides of (B, Sk)
  int B, H, Sq, Sk, D;
  int causal, off;  // off = Sk - Sq
  float scale;
};

// dst[r][d] (row stride ld) = src row (row0 + r) of head (b, h), for r <
// kTile and d < D; rows at or past n_rows are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          const long long* st, int b, int h,
                                          int row0, int n_rows, int D) {
  const long long base = b * st[0] + h * st[2];
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < n_rows) val = to_float(src[base + row * st[1] + d * st[3]]);
    dst[r * ld + d] = val;
  }
}

// out[i][j] = sum_d A[r0 + i][d] * Bm[c0 + 16 j][d] over d < D (A and Bm
// with row stride ld, D a multiple of 4).
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         int ld, int D, int r0, int c0,
                                         float out[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bm + (c0 + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = out[i][j];
        s = fmaf(a[i].x, bv[j].x, s);
        s = fmaf(a[i].y, bv[j].y, s);
        s = fmaf(a[i].z, bv[j].z, s);
        s = fmaf(a[i].w, bv[j].w, s);
        out[i][j] = s;
      }
  }
}

// acc[i][4 jj + e] += sum_c P[r0 + i][c] * M[c][4 tx + 64 jj + e] over the
// kTile columns c of P (row stride kLdS) and the head-dim columns below D
// (M with row stride ld).
__device__ __forceinline__ void acc_tile(const float* P, const float* M,
                                         int ld, int D, int r0, int tx,
                                         float acc[4][8]) {
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (r0 + i) * kLdS + c);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int d0 = 4 * tx + 64 * jj;
      if (d0 >= D) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 m =
            *reinterpret_cast<const float4*>(M + (c + cc) * ld + d0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = cc == 0 ? p[i].x
                           : cc == 1 ? p[i].y
                           : cc == 2 ? p[i].z
                                     : p[i].w;
          acc[i][4 * jj + 0] = fmaf(pv, m.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pv, m.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pv, m.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pv, m.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// Max and sum over the 16 lanes that share a row (a half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The scaled, biased, masked fp32 score of query `qrow` against key `kcol`
// (`_scores` :132): the mask replaces the value; keys or queries past the
// sequence are masked too.
__device__ __forceinline__ float score(const Params& p, float dot, float bias,
                                       int qrow, int kcol) {
  float s = dot * p.scale;
  if (p.bias != nullptr) s += bias;
  if (kcol >= p.Sk || qrow >= p.Sq || (p.causal && qrow + p.off < kcol))
    s = kMask;
  return s;
}

__device__ __forceinline__ float key_bias(const Params& p, int b, int kcol) {
  return (p.bias != nullptr && kcol < p.Sk)
             ? p.bias[b * p.sbias[0] + kcol * p.sbias[1]]
             : 0.f;
}

// The last k/v tile a q tile starting at q0 sees (all of them without the
// causal mask).
__device__ __forceinline__ int last_kv_tile(const Params& p, int q0) {
  const int nk = (p.Sk + kTile - 1) / kTile;
  if (!p.causal) return nk - 1;
  return min(nk - 1, (q0 + p.off + kTile - 1) / kTile);
}

template <typename T>
__device__ __forceinline__ void store_rows(T* dst, int b, int h, int row0,
                                           int n_rows, const Params& p,
                                           int r0, int tx,
                                           const float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + r0 + i;
    if (row >= n_rows) continue;
    T* out = dst + ((static_cast<long long>(b) * n_rows + row) * p.H + h) *
                       p.D;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int d0 = 4 * tx + 64 * jj;
      if (d0 >= p.D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[d0 + e] = from_float<T>(acc[i][4 * jj + e]);
    }
  }
}

// ---- forward: one block per (b * H + h, q tile) -------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  const int ld = p.D + 4;
  float* sK = sQ + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sP = sV + kTile * ld;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, r0 = 4 * ty;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  load_tile(sQ, ld, q, p.sq, b, h, q0, p.Sq, p.D);
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }
  const int last = last_kv_tile(p, q0);
  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's sK, sV and sP are read
    load_tile(sK, ld, k, p.sk, b, h, k0, p.Sk, p.D);
    load_tile(sV, ld, v, p.sv, b, h, k0, p.Sk, p.D);
    __syncthreads();
    float s[4][4];
    dot_tile(sQ, sK, ld, p.D, r0, tx, s);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kcol = k0 + tx + 16 * c;
      const float bias = key_bias(p, b, kcol);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][c] = score(p, s[i][c], bias, q0 + r0 + i, kcol);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = expf(s[i][c] - m_new);
        rs += pv;
        sP[(r0 + i) * kLdS + tx + 16 * c] = round_to<T>(pv);
      }
      l[i] = l[i] * alpha + row_sum(rs);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    acc_tile(sP, sV, ld, p.D, r0, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] /= lsafe;
    const int row = q0 + r0 + i;
    if (tx == 0 && row < p.Sq)
      p.lse_out[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
          m[i] + logf(lsafe);
  }
  store_rows(static_cast<T*>(p.out), b, h, q0, p.Sq, p, r0, tx, acc);
}

// ---- dQ: one block per (b * H + h, q tile) ------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_dq_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  const int ld = p.D + 4;
  float* sdO = sQ + kTile * ld;
  float* sK = sdO + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sdS = sV + kTile * ld;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, r0 = 4 * ty;

  load_tile(sQ, ld, static_cast<const T*>(p.q), p.sq, b, h, q0, p.Sq, p.D);
  load_tile(sdO, ld, static_cast<const T*>(p.dout), p.sdo, b, h, q0, p.Sq,
            p.D);
  float lse[4], delta[4], dq[4][8];
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    lse[i] = row < p.Sq ? p.lse[row_base + row] : 0.f;
    delta[i] = row < p.Sq ? p.delta[row_base + row] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) dq[i][e] = 0.f;
  }
  const int last = last_kv_tile(p, q0);
  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_tile(sK, ld, static_cast<const T*>(p.k), p.sk, b, h, k0, p.Sk, p.D);
    load_tile(sV, ld, static_cast<const T*>(p.v), p.sv, b, h, k0, p.Sk, p.D);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile(sQ, sK, ld, p.D, r0, tx, s);
    dot_tile(sdO, sV, ld, p.D, r0, tx, dp);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kcol = k0 + tx + 16 * c;
      const float bias = key_bias(p, b, kcol);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv =
            expf(score(p, s[i][c], bias, q0 + r0 + i, kcol) - lse[i]);
        sdS[(r0 + i) * kLdS + tx + 16 * c] =
            round_to<T>(pv * (dp[i][c] - delta[i]) * p.scale);
      }
    }
    __syncthreads();
    acc_tile(sdS, sK, ld, p.D, r0, tx, dq);
  }
  store_rows(static_cast<T*>(p.out), b, h, q0, p.Sq, p, r0, tx, dq);
}

// ---- dK, dV: one block per (b * H + h, k/v tile) ------------------------
// The thread layout of the two kernels above with keys as the rows: a
// thread owns 4 keys and 4 queries (16 apart) of the transposed score
// tile, and 4 keys x 8 head-dim columns of dK and dV.

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_dkdv_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  const int ld = p.D + 4;
  float* sV = sK + kTile * ld;
  float* sQ = sV + kTile * ld;
  float* sdO = sQ + kTile * ld;
  float* sPT = sdO + kTile * ld;
  float* sdST = sPT + kTile * kLdS;
  float* sLse = sdST + kTile * kLdS;
  float* sDelta = sLse + kTile;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, r0 = 4 * ty;

  load_tile(sK, ld, static_cast<const T*>(p.k), p.sk, b, h, k0, p.Sk, p.D);
  load_tile(sV, ld, static_cast<const T*>(p.v), p.sv, b, h, k0, p.Sk, p.D);
  float bias[4], dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bias[i] = key_bias(p, b, k0 + r0 + i);
#pragma unroll
    for (int e = 0; e < 8; ++e) dk[i][e] = dv[i][e] = 0.f;
  }
  const int nq = (p.Sq + kTile - 1) / kTile;
  int first = 0;  // the first q tile that sees this k/v tile
  if (p.causal) {
    const int lo = k0 - p.off - kTile + 1;
    first = lo > 0 ? (lo + kTile - 1) / kTile : 0;
  }
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
  for (int i_tile = first; i_tile < nq; ++i_tile) {
    const int q0 = i_tile * kTile;
    __syncthreads();
    load_tile(sQ, ld, static_cast<const T*>(p.q), p.sq, b, h, q0, p.Sq, p.D);
    load_tile(sdO, ld, static_cast<const T*>(p.dout), p.sdo, b, h, q0, p.Sq,
              p.D);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < p.Sq ? p.lse[row_base + row] : 0.f;
      sDelta[threadIdx.x] = row < p.Sq ? p.delta[row_base + row] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    dot_tile(sK, sQ, ld, p.D, r0, tx, st);
    dot_tile(sV, sdO, ld, p.D, r0, tx, dpt);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qc = tx + 16 * c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv =
            expf(score(p, st[i][c], bias[i], q0 + qc, k0 + r0 + i) -
                 sLse[qc]);
        sPT[(r0 + i) * kLdS + qc] = round_to<T>(pv);
        sdST[(r0 + i) * kLdS + qc] =
            round_to<T>(pv * (dpt[i][c] - sDelta[qc]) * p.scale);
      }
    }
    __syncthreads();
    acc_tile(sPT, sdO, ld, p.D, r0, tx, dv);
    acc_tile(sdST, sQ, ld, p.D, r0, tx, dk);
  }
  store_rows(static_cast<T*>(p.dk), b, h, k0, p.Sk, p, r0, tx, dk);
  store_rows(static_cast<T*>(p.dv), b, h, k0, p.Sk, p, r0, tx, dv);
}

size_t smem_bytes(int kind, int D) {
  const size_t tile = static_cast<size_t>(kTile) * (D + 4);
  const size_t score = static_cast<size_t>(kTile) * kLdS;
  switch (kind) {
    case 0:  // forward: Q, K, V, P
      return (3 * tile + score) * sizeof(float);
    case 1:  // dQ: Q, dO, K, V, dS
      return (4 * tile + score) * sizeof(float);
    default:  // dK/dV: K, V, Q, dO, P^T, dS^T, lse, Delta
      return (4 * tile + 2 * score + 2 * kTile) * sizeof(float);
  }
}

template <typename T>
int launch(int kind, const Params& p, cudaStream_t stream) {
  const int rows = kind == 2 ? p.Sk : p.Sq;
  const dim3 grid(p.B * p.H, (rows + kTile - 1) / kTile);
  const size_t bytes = smem_bytes(kind, p.D);
  void (*kernel)(Params) = kind == 0   ? attn_fwd_kernel<T>
                           : kind == 1 ? attn_dq_kernel<T>
                                       : attn_dkdv_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dims: B, H, Sq, Sk, D, causal.  strides: 4 each for q, k, v, dO (the
// forward ignores dO's) and 2 for the bias.
int run(int kind, const long long* dims, const long long* strides,
        const void* q, const void* k, const void* v, const void* dout,
        const void* bias, const void* lse, const void* delta, void* out,
        void* lse_out, void* dk, void* dv, float scale, int dtype,
        void* stream) {
  const long long B = dims[0], H = dims[1], Sq = dims[2], Sk = dims[3],
                  D = dims[4];
  if (D < 8 || D > kMaxD || D % 8 != 0) return -2;
  const long long max_tiles = 65535LL * kTile;
  if (Sq < 1 || Sk < 1 || Sq > max_tiles || Sk > max_tiles) return -3;
  if (B < 1 || H < 1 || B * H > 0x7fffffffLL) return -4;
  if (dims[5] && Sq > Sk) return -5;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = out;
  p.lse_out = static_cast<float*>(lse_out);
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 4; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
    p.sdo[i] = strides[12 + i];
  }
  p.sbias[0] = strides[16];
  p.sbias[1] = strides[17];
  p.B = static_cast<int>(B);
  p.H = static_cast<int>(H);
  p.Sq = static_cast<int>(Sq);
  p.Sk = static_cast<int>(Sk);
  p.D = static_cast<int>(D);
  p.causal = dims[5] != 0;
  p.off = static_cast<int>(Sk - Sq);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(kind, p, s);
    case 1:
      return launch<__nv_bfloat16>(kind, p, s);
    case 2:
      return launch<__half>(kind, p, s);
    default:
      return -1;
  }
}

}  // namespace

// Forward: O (B, Sq, H, D) in the input dtype and lse (B, H, Sq) fp32.
// Argument errors are negative; a launch error is the cudaError_t value.
extern "C" int apex_attn_fwd(const long long* dims, const long long* strides,
                             const void* q, const void* k, const void* v,
                             const void* bias, void* out, void* lse,
                             float scale, int dtype, void* stream) {
  return run(0, dims, strides, q, k, v, nullptr, bias, nullptr, nullptr, out,
             lse, nullptr, nullptr, scale, dtype, stream);
}

// dQ (B, Sq, H, D) in the input dtype, from lse and Delta (B, H, Sq) fp32.
extern "C" int apex_attn_dq(const long long* dims, const long long* strides,
                            const void* q, const void* k, const void* v,
                            const void* dout, const void* bias,
                            const void* lse, const void* delta, void* dq,
                            float scale, int dtype, void* stream) {
  return run(1, dims, strides, q, k, v, dout, bias, lse, delta, dq, nullptr,
             nullptr, nullptr, scale, dtype, stream);
}

// dK and dV (B, Sk, H, D) in the input dtype.
extern "C" int apex_attn_dkdv(const long long* dims, const long long* strides,
                              const void* q, const void* k, const void* v,
                              const void* dout, const void* bias,
                              const void* lse, const void* delta, void* dk,
                              void* dv, float scale, int dtype,
                              void* stream) {
  return run(2, dims, strides, q, k, v, dout, bias, lse, delta, nullptr,
             nullptr, dk, dv, scale, dtype, stream);
}

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
