// LAMB stage 1 and stage 2, Adam, momentum SGD, NovoGrad and Adagrad, for
// Hopper (sm_90a), bound with ctypes.
//
// Replace apex_example_tpu/ops/fused_optim.py:137 `_lamb1_kernel` (launched
// per leaf by `lamb_stage1_leaf`, :167 / :196) and :219 `_lamb2_kernel`
// (`lamb_stage2_leaf`, :225 / :242), with the per-tensor trust ratio of
// apex_example_tpu/optim/fused.py:135-136 computed on the card between them.
//
// Stage 1, per element (fp32 arithmetic, as at fused_optim.py:146-154):
//   g' = g * gscale;  m = b1*m + (1-b1)*g';  v = b2*v + (1-b2)*g'*g'
//   u  = (m*c1) / (sqrt(v*c2) + eps) + wd*p
// m and v are updated in place (fp32), u goes to one flat fp32 buffer, and
// per tensor ||p||^2 and ||u||^2 are summed; then per tensor
//   ratio = (||p|| > 0 and ||u|| > 0) ? ||p|| / ||u|| : 1.
// gscale is LAMB's global-norm clip, where(gnorm > max, max/(gnorm+1e-6), 1)
// (optim/fused.py:120-124), computed by each block from the grad norm that
// multi_tensor.cu left on the card: no host sync reads it.  The step's
// scalars (lr, c1, c2) are a row on the card, (lr, c1, c2) = scal[0..2],
// that the optimizer's device step count indexes (lamb_step_scalars at
// :102-117 computes them in JAX from its traced step), so that a skipped
// step leaves the next one JAX's bias corrections; b1, b2, eps, wd and the
// clip bound are kernel arguments.
// Stage 2, per element: p -= (lr * ratio[t]) * u, p in place.
// noop: apex's noop_flag, an int32 on the card (the loss scaler's
// non-finite flag).  When it is nonzero every block of the three stage-1
// kernels and of stage 2 returns before it writes: m, v, u, the per-tensor
// sums, the trust ratios and p stay as they were (JAX's select_tree of the
// old params and LambState, workloads.py:149-153), and an inf grad norm of
// an overflow step reaches no state.
//
// Bound: bytes.  Stage 1 reads p, g, m, v and writes m, v, u: 28 bytes per
// fp32 element, 3.07 GB for bert_base's 109.5 M, ~0.915 ms at 3.35 TB/s.
// Stage 2 reads p and u and writes p: 12 bytes per element, ~0.39 ms.
// Both do a few tens of operations per element, far below the fp32 rate.
//
// Design: the tensor-list launch of multi_tensor_apply.cuh.  Each list of
// 201 tensors is one launch of one block per 64 Ki-element chunk, p, g, m, v
// read once and m, v, u written once; the TPU kernel's across-grid SMEM
// accumulators for the norms become per-chunk partials reduced per tensor
// in chunk order (no float atomics, so the norms repeat bitwise).  A model
// of several parameter dtypes (amp O3) is one table per dtype, each its own
// launches with its own u; the clip reads the norm over every table.  Each
// element's arithmetic is one expression in a fixed order, the same whether
// a scalar comes from the card or from an argument, so fp32 results are
// bitwise those of the kernels that took host floats.
//
// Adam / AdamW.  Replaces apex_example_tpu/ops/fused_optim.py:53
// `_adam_kernel` (launched once per leaf by `adam_update_leaf`, :75 / :101,
// from optim/fused.py:86-91).  Per element, fp32 arithmetic with the seven
// scalars in fp32 as the TPU kernel receives them (:95-97), lr, c1 and c2 a
// row on the card, (lr, c1, c2) = scal[0..2], indexed by the optimizer's
// device step count (FusedAdam.apply :72-78 computes them from its step):
//   Adam  (adam_w = 0): g += wd*p
//   m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
//   u = (m*c1) / (sqrt(v*c2) + eps);  AdamW (adam_w = 1): u += wd*p
//   p -= lr*u
// p, m and v are updated in place; p and g are fp32, bf16 or fp16, m and v
// fp32.  noop (apex's noop_flag) nonzero: every block returns before it
// writes, so a skipped step leaves p, m and v as they were.  Bound: bytes.  p, g, m, v read and p, m, v written: 28 bytes per
// fp32 element, 4.22 GB for Transformer-XL's 150.9 M, ~1.26 ms at 3.35 TB/s;
// about 15 operations per element, far below the fp32 rate.  Design: the
// whole list in one launch (the JAX package's loop would be 241 launches
// from Python a step), one block per chunk, 16-byte vector loads and stores
// of four elements where the chunk's four pointers are 16-byte aligned,
// scalar ones otherwise and for the ragged tail; one launch per parameter
// dtype (two under amp O3).
//
// Momentum SGD.  Replaces apex_example_tpu/ops/fused_optim.py:259
// `_sgd_kernel` (launched once per leaf by `sgd_update_leaf`, :331 / :358,
// from optim/fused.py:299-310).  Per element, fp32 arithmetic with fp32
// scalars, as the TPU kernel takes them:
//   g += wd*p
//   buf = first_step ? g : mom*buf + (1-damp)*g
//   dir = nesterov ? g + mom*buf : buf
//   p  -= lr*dir
// p in place (fp32, bf16 or fp16, the grads of p's dtype), buf in place
// (fp32).  lr is a host float, or read from the card (a schedule indexed by
// the optimizer's device step count).  noop: apex's noop_flag, an int32 on
// the card (the loss scaler's non-finite flag); when it is nonzero every
// block returns before writing, so a skipped step leaves p and buf as they
// were, with no host sync.  Bound: bytes.  p read and written, g read, buf
// read and written: 20 bytes per fp32 element; ResNet-50's 25.6 M
// parameters move 511 MB, ~0.153 ms at 3.35 TB/s; about 7 operations per
// element.  Design as Adam's: the whole list (of one dtype) in one launch,
// one block per chunk, 16-byte vector loads where aligned.
//
// NovoGrad.  Replaces apex_example_tpu/ops/fused_optim.py:274
// `_novograd_kernel` (launched once per leaf by `novograd_update_leaf`,
// :285 / :317) and the per-leaf scalar work around it in
// apex_example_tpu/optim/fused.py:252-259.  The second moment v is ONE fp32
// per tensor, the EMA of the tensor's squared grad norm sq (the L2-norm
// kernel's per-tensor output, multi_tensor.cu).  The chunks of one tensor
// run in different blocks, in no order, so no chunk may read v[t] while
// another writes it: a small per-tensor kernel (one thread a tensor, as
// LAMB's trust_ratio_kernel) first computes
//   v' = (first step and not init_zero) ? sq : b2*v + (1-b2)*sq
//   inv_denom = 1 / (sqrt(v' * c2) + eps)
// and writes v in place and inv_denom to a [T] buffer; then the chunk
// kernel, per element, in fp32 as the TPU kernel:
//   g^ = g * inv_denom[t] + wd*p;  m = b1*m + ga*g^;  p -= lr_c1*m
// (ga = 1 - b1 under grad averaging, else 1; lr_c1 = lr * c1 folds the
// bias correction in).  lr_c1 and c2 are read from the card (a row of the
// optimizer's per-step table, indexed by its device step count), and the
// first-step branch is the device count being 0.  noop (apex's noop_flag)
// nonzero: both kernels return before writing, so a skipped step leaves p,
// m and v as they were.  Bound: bytes.  p, g, m read
// and p, m written: 20 bytes per fp32 element (the [T] vectors are noise):
// bert_base's 109.5 M parameters move 2.19 GB, ~0.654 ms at 3.35 TB/s; about
// 7 operations per element.  Design as Adam's for the chunk kernel.
//
// Adagrad.  Replaces apex_example_tpu/ops/fused_optim.py:380
// `_adagrad_kernel` (launched once per leaf by `adagrad_update_leaf`, :396 /
// :418).  Per element, fp32 arithmetic with fp32 scalars:
//   L2 mode (w_mode = 0): g += wd*p
//   h += g*g;  u = g / (sqrt(h) + eps);  w_mode: u += wd*p
//   p -= lr*u
// p (fp32, bf16 or fp16, g of p's dtype) and h (fp32) in place; lr a host
// float or read from the card, and the noop flag as SGD's.  Bound: bytes,
// the same 20 bytes per fp32 element as SGD: ResNet-50's 25.6 M parameters,
// ~0.153 ms.  Design as SGD's.

#include "multi_tensor_apply.cuh"

namespace {

using mta::Chunk;
using mta::Table;

struct AdamArgs {
  float beta1, beta2, eps, weight_decay;
  int adam_w;
};

// The step's scalars, read from the card: (lr, c1, c2).
struct StepScalars {
  float lr, c1, c2;
};

__device__ __forceinline__ StepScalars read_scalars(
    const float* __restrict__ scal) {
  return StepScalars{scal[0], scal[1], scal[2]};
}

__device__ __forceinline__ void adam_element(const AdamArgs& a,
                                             const StepScalars& s, float& p,
                                             float g, float& m, float& v) {
  if (!a.adam_w) g = g + a.weight_decay * p;
  m = a.beta1 * m + (1.f - a.beta1) * g;
  v = a.beta2 * v + (1.f - a.beta2) * g * g;
  float u = (m * s.c1) / (sqrtf(v * s.c2) + a.eps);
  if (a.adam_w) u = u + a.weight_decay * p;
  p = p - s.lr * u;
}

// ptrs lists: 0 = p, 1 = g (dtype T), 2 = m, 3 = v (fp32).
template <typename T>
__global__ void __launch_bounds__(mta::kThreads)
    adam_chunks_kernel(Table tab, AdamArgs a, const float* __restrict__ scal,
                       const int* __restrict__ noop) {
  if (noop != nullptr && *noop != 0) return;
  const StepScalars sc = read_scalars(scal);
  const Chunk k = mta::chunk_of(tab, blockIdx.x);
  const long long n = tab.n_tensors;
  T* p = reinterpret_cast<T*>(tab.ptrs[k.tensor]) + k.start;
  const T* g = reinterpret_cast<const T*>(tab.ptrs[n + k.tensor]) + k.start;
  float* m = reinterpret_cast<float*>(tab.ptrs[2 * n + k.tensor]) + k.start;
  float* v = reinterpret_cast<float*>(tab.ptrs[3 * n + k.tensor]) + k.start;
  int i = threadIdx.x;
  if (mta::aligned16(p) && mta::aligned16(g) && mta::aligned16(m) &&
      mta::aligned16(v)) {
    const int nvec = k.len / 4;
    for (; i < nvec; i += mta::kThreads) {
      float pf[4], gf[4], mf[4], vf[4];
      mta::load4(p + 4 * i, pf);
      mta::load4(g + 4 * i, gf);
      mta::load4(m + 4 * i, mf);
      mta::load4(v + 4 * i, vf);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        adam_element(a, sc, pf[u], gf[u], mf[u], vf[u]);
      mta::store4(p + 4 * i, pf);
      mta::store4(m + 4 * i, mf);
      mta::store4(v + 4 * i, vf);
    }
    i = 4 * nvec + threadIdx.x;       // the ragged tail, scalar
  }
  for (; i < k.len; i += mta::kThreads) {
    float pf = mta::to_float(p[i]), mf = m[i], vf = v[i];
    adam_element(a, sc, pf, mta::to_float(g[i]), mf, vf);
    p[i] = mta::from_float<T>(pf);
    m[i] = mf;
    v[i] = vf;
  }
}

template <typename T>
int run_adam(const Table& tab, const AdamArgs& a, const float* scal,
             const int* noop, cudaStream_t stream) {
  if (tab.n_chunks == 0) return 0;
  adam_chunks_kernel<T><<<static_cast<unsigned>(tab.n_chunks), mta::kThreads,
                          0, stream>>>(tab, a, scal, noop);
  return static_cast<int>(cudaGetLastError());
}

struct SgdArgs {
  float lr, momentum, weight_decay, dampening;
  int nesterov, first_step;
};

__device__ __forceinline__ void sgd_element(const SgdArgs& a, float lr,
                                            float& p, float g, float& b) {
  g = g + a.weight_decay * p;
  b = a.first_step ? g : a.momentum * b + (1.f - a.dampening) * g;
  const float dir = a.nesterov ? g + a.momentum * b : b;
  p = p - lr * dir;
}

// ptrs lists: 0 = p, 1 = g (dtype T), 2 = buf (fp32).
template <typename T>
__global__ void __launch_bounds__(mta::kThreads)
    sgd_chunks_kernel(Table tab, SgdArgs a, const float* __restrict__ lr_dev,
                      const int* __restrict__ noop) {
  if (noop != nullptr && *noop != 0) return;
  const float lr = lr_dev != nullptr ? *lr_dev : a.lr;
  const Chunk k = mta::chunk_of(tab, blockIdx.x);
  const long long n = tab.n_tensors;
  T* p = reinterpret_cast<T*>(tab.ptrs[k.tensor]) + k.start;
  const T* g = reinterpret_cast<const T*>(tab.ptrs[n + k.tensor]) + k.start;
  float* b = reinterpret_cast<float*>(tab.ptrs[2 * n + k.tensor]) + k.start;
  int i = threadIdx.x;
  if (mta::aligned16(p) && mta::aligned16(g) && mta::aligned16(b)) {
    const int nvec = k.len / 4;
    for (; i < nvec; i += mta::kThreads) {
      float pf[4], gf[4], bf[4];
      mta::load4(p + 4 * i, pf);
      mta::load4(g + 4 * i, gf);
      mta::load4(b + 4 * i, bf);
#pragma unroll
      for (int u = 0; u < 4; ++u) sgd_element(a, lr, pf[u], gf[u], bf[u]);
      mta::store4(p + 4 * i, pf);
      mta::store4(b + 4 * i, bf);
    }
    i = 4 * nvec + threadIdx.x;       // the ragged tail, scalar
  }
  for (; i < k.len; i += mta::kThreads) {
    float pf = mta::to_float(p[i]), bf = b[i];
    sgd_element(a, lr, pf, mta::to_float(g[i]), bf);
    p[i] = mta::from_float<T>(pf);
    b[i] = bf;
  }
}

template <typename T>
int run_sgd(const Table& tab, const SgdArgs& a, const float* lr_dev,
            const int* noop, cudaStream_t stream) {
  if (tab.n_chunks == 0) return 0;
  sgd_chunks_kernel<T><<<static_cast<unsigned>(tab.n_chunks), mta::kThreads,
                         0, stream>>>(tab, a, lr_dev, noop);
  return static_cast<int>(cudaGetLastError());
}

struct Lamb1Args {
  float beta1, beta2, eps, weight_decay, max_grad_norm;
};

// ptrs lists: 0 = p, 1 = g (dtype T), 2 = m, 3 = v (fp32).
template <typename T>
__global__ void __launch_bounds__(mta::kThreads)
    lamb1_chunks_kernel(Table tab, Lamb1Args a,
                        const float* __restrict__ gnorm,
                        const float* __restrict__ scal,
                        const int* __restrict__ noop, float* __restrict__ u,
                        float* __restrict__ partial) {
  __shared__ float smem[mta::kThreads / 32];
  if (noop != nullptr && *noop != 0) return;
  const float c1 = scal[1], c2 = scal[2];
  const Chunk k = mta::chunk_of(tab, blockIdx.x);
  const long long n = tab.n_tensors;
  const T* p = reinterpret_cast<const T*>(tab.ptrs[k.tensor]) + k.start;
  const T* g = reinterpret_cast<const T*>(tab.ptrs[n + k.tensor]) + k.start;
  float* m = reinterpret_cast<float*>(tab.ptrs[2 * n + k.tensor]) + k.start;
  float* v = reinterpret_cast<float*>(tab.ptrs[3 * n + k.tensor]) + k.start;
  float* ut = u + k.flat + k.start;

  float gscale = 1.f;
  if (gnorm != nullptr) {
    const float gn = gnorm[0];
    if (gn > a.max_grad_norm) gscale = a.max_grad_norm / (gn + 1e-6f);
  }
  const float b1 = a.beta1, b2 = a.beta2;
  float pp = 0.f, uu = 0.f;
  for (int base = threadIdx.x; base < k.len;
       base += mta::kUnroll * mta::kThreads) {
    float pf[mta::kUnroll], gf[mta::kUnroll], mf[mta::kUnroll],
        vf[mta::kUnroll];
#pragma unroll
    for (int s = 0; s < mta::kUnroll; ++s) {
      const int i = base + s * mta::kThreads;
      if (i < k.len) {
        pf[s] = mta::to_float(p[i]);
        gf[s] = mta::to_float(g[i]);
        mf[s] = m[i];
        vf[s] = v[i];
      }
    }
#pragma unroll
    for (int s = 0; s < mta::kUnroll; ++s) {
      const int i = base + s * mta::kThreads;
      if (i < k.len) {
        const float gs = gf[s] * gscale;
        const float mn = b1 * mf[s] + (1.f - b1) * gs;
        const float vn = b2 * vf[s] + (1.f - b2) * gs * gs;
        const float un =
            (mn * c1) / (sqrtf(vn * c2) + a.eps) + a.weight_decay * pf[s];
        m[i] = mn;
        v[i] = vn;
        ut[i] = un;
        pp += pf[s] * pf[s];
        uu += un * un;
      }
    }
  }
  pp = mta::block_sum(pp, smem);
  uu = mta::block_sum(uu, smem);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = pp;
    partial[tab.n_chunks + blockIdx.x] = uu;
  }
}

// sums[0 * n + t] = ||p_t||^2, sums[1 * n + t] = ||u_t||^2 -> ratio[t].
__global__ void __launch_bounds__(256)
    trust_ratio_kernel(const float* __restrict__ sums, int n_tensors,
                       float* __restrict__ ratio,
                       const int* __restrict__ noop) {
  if (noop != nullptr && *noop != 0) return;
  const int t = blockIdx.x * 256 + threadIdx.x;
  if (t >= n_tensors) return;
  const float w = sqrtf(sums[t]);
  const float un = sqrtf(sums[n_tensors + t]);
  ratio[t] = (w > 0.f && un > 0.f) ? w / un : 1.f;
}

template <typename T>
__global__ void __launch_bounds__(mta::kThreads)
    lamb2_chunks_kernel(Table tab, const float* __restrict__ u,
                        const float* __restrict__ ratio,
                        const float* __restrict__ scal,
                        const int* __restrict__ noop) {
  if (noop != nullptr && *noop != 0) return;
  const Chunk k = mta::chunk_of(tab, blockIdx.x);
  T* p = reinterpret_cast<T*>(tab.ptrs[k.tensor]) + k.start;
  const float* ut = u + k.flat + k.start;
  const float scaled_lr = scal[0] * ratio[k.tensor];
  for (int base = threadIdx.x; base < k.len;
       base += mta::kUnroll * mta::kThreads) {
    float pf[mta::kUnroll], uf[mta::kUnroll];
#pragma unroll
    for (int s = 0; s < mta::kUnroll; ++s) {
      const int i = base + s * mta::kThreads;
      if (i < k.len) {
        pf[s] = mta::to_float(p[i]);
        uf[s] = ut[i];
      }
    }
#pragma unroll
    for (int s = 0; s < mta::kUnroll; ++s) {
      const int i = base + s * mta::kThreads;
      if (i < k.len) p[i] = mta::from_float<T>(pf[s] - scaled_lr * uf[s]);
    }
  }
}

template <typename T>
int run_stage1(const Table& tab, const Lamb1Args& a, const float* gnorm,
               const float* scal, const int* noop, float* u, float* partial,
               float* sums, float* ratio, cudaStream_t stream) {
  if (tab.n_chunks > 0) {
    lamb1_chunks_kernel<T><<<static_cast<unsigned>(tab.n_chunks),
                             mta::kThreads, 0, stream>>>(tab, a, gnorm, scal,
                                                         noop, u, partial);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  int rc = mta::launch_tensor_sums(tab, 2, partial, sums, stream, noop);
  if (rc != 0) return rc;
  trust_ratio_kernel<<<static_cast<unsigned>((tab.n_tensors + 255) / 256),
                       256, 0, stream>>>(sums, tab.n_tensors, ratio, noop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_stage2(const Table& tab, const float* u, const float* ratio,
               const float* scal, const int* noop, cudaStream_t stream) {
  if (tab.n_chunks == 0) return 0;
  lamb2_chunks_kernel<T><<<static_cast<unsigned>(tab.n_chunks),
                           mta::kThreads, 0, stream>>>(tab, u, ratio, scal,
                                                       noop);
  return static_cast<int>(cudaGetLastError());
}

struct NovoArgs {
  float beta1, beta2, one_minus_beta2, eps, weight_decay, grad_avg_coeff;
  int init_zero;
};

// One thread a tensor: v' from sq, and inv_denom.  scal: (lr_c1, c2) on the
// card; step: the steps taken before this one (the first step when 0).
__global__ void __launch_bounds__(256)
    novograd_moment_kernel(int n_tensors, NovoArgs a,
                           const float* __restrict__ sq, float* __restrict__ v,
                           float* __restrict__ inv_denom,
                           const float* __restrict__ scal,
                           const int* __restrict__ step,
                           const int* __restrict__ noop) {
  if (noop != nullptr && *noop != 0) return;
  const int t = blockIdx.x * 256 + threadIdx.x;
  if (t >= n_tensors) return;
  const float c2 = scal[1];
  const bool first = *step == 0;
  const float s = sq[t];
  const float vn = (first && !a.init_zero)
                       ? s
                       : a.beta2 * v[t] + a.one_minus_beta2 * s;
  v[t] = vn;
  inv_denom[t] = 1.f / (sqrtf(vn * c2) + a.eps);
}

__device__ __forceinline__ void novograd_element(const NovoArgs& a,
                                                 float inv, float lr_c1,
                                                 float& p, float g,
                                                 float& m) {
  const float gh = g * inv + a.weight_decay * p;
  m = a.beta1 * m + a.grad_avg_coeff * gh;
  p = p - lr_c1 * m;
}

// ptrs lists: 0 = p, 1 = g (dtype T), 2 = m (fp32).
template <typename T>
__global__ void __launch_bounds__(mta::kThreads)
    novograd_chunks_kernel(Table tab, NovoArgs a,
                           const float* __restrict__ inv_denom,
                           const float* __restrict__ scal,
                           const int* __restrict__ noop) {
  if (noop != nullptr && *noop != 0) return;
  const float lr_c1 = scal[0];
  const Chunk k = mta::chunk_of(tab, blockIdx.x);
  const float inv = inv_denom[k.tensor];
  const long long n = tab.n_tensors;
  T* p = reinterpret_cast<T*>(tab.ptrs[k.tensor]) + k.start;
  const T* g = reinterpret_cast<const T*>(tab.ptrs[n + k.tensor]) + k.start;
  float* m = reinterpret_cast<float*>(tab.ptrs[2 * n + k.tensor]) + k.start;
  int i = threadIdx.x;
  if (mta::aligned16(p) && mta::aligned16(g) && mta::aligned16(m)) {
    const int nvec = k.len / 4;
    for (; i < nvec; i += mta::kThreads) {
      float pf[4], gf[4], mf[4];
      mta::load4(p + 4 * i, pf);
      mta::load4(g + 4 * i, gf);
      mta::load4(m + 4 * i, mf);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        novograd_element(a, inv, lr_c1, pf[u], gf[u], mf[u]);
      mta::store4(p + 4 * i, pf);
      mta::store4(m + 4 * i, mf);
    }
    i = 4 * nvec + threadIdx.x;       // the ragged tail, scalar
  }
  for (; i < k.len; i += mta::kThreads) {
    float pf = mta::to_float(p[i]), mf = m[i];
    novograd_element(a, inv, lr_c1, pf, mta::to_float(g[i]), mf);
    p[i] = mta::from_float<T>(pf);
    m[i] = mf;
  }
}

template <typename T>
int run_novograd(const Table& tab, const NovoArgs& a, const float* sq,
                 float* v, float* inv_denom, const float* scal,
                 const int* step, const int* noop, cudaStream_t stream) {
  novograd_moment_kernel<<<static_cast<unsigned>((tab.n_tensors + 255) / 256),
                           256, 0, stream>>>(tab.n_tensors, a, sq, v,
                                             inv_denom, scal, step, noop);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || tab.n_chunks == 0) return rc;
  novograd_chunks_kernel<T><<<static_cast<unsigned>(tab.n_chunks),
                              mta::kThreads, 0, stream>>>(tab, a, inv_denom,
                                                          scal, noop);
  return static_cast<int>(cudaGetLastError());
}

struct AdagradArgs {
  float lr, eps, weight_decay;
  int w_mode;
};

__device__ __forceinline__ void adagrad_element(const AdagradArgs& a,
                                                float lr, float& p, float g,
                                                float& h) {
  if (!a.w_mode) g = g + a.weight_decay * p;
  h = h + g * g;
  float u = g / (sqrtf(h) + a.eps);
  if (a.w_mode) u = u + a.weight_decay * p;
  p = p - lr * u;
}

// ptrs lists: 0 = p, 1 = g (dtype T), 2 = h (fp32).
template <typename T>
__global__ void __launch_bounds__(mta::kThreads)
    adagrad_chunks_kernel(Table tab, AdagradArgs a,
                          const float* __restrict__ lr_dev,
                          const int* __restrict__ noop) {
  if (noop != nullptr && *noop != 0) return;
  const float lr = lr_dev != nullptr ? *lr_dev : a.lr;
  const Chunk k = mta::chunk_of(tab, blockIdx.x);
  const long long n = tab.n_tensors;
  T* p = reinterpret_cast<T*>(tab.ptrs[k.tensor]) + k.start;
  const T* g = reinterpret_cast<const T*>(tab.ptrs[n + k.tensor]) + k.start;
  float* h = reinterpret_cast<float*>(tab.ptrs[2 * n + k.tensor]) + k.start;
  int i = threadIdx.x;
  if (mta::aligned16(p) && mta::aligned16(g) && mta::aligned16(h)) {
    const int nvec = k.len / 4;
    for (; i < nvec; i += mta::kThreads) {
      float pf[4], gf[4], hf[4];
      mta::load4(p + 4 * i, pf);
      mta::load4(g + 4 * i, gf);
      mta::load4(h + 4 * i, hf);
#pragma unroll
      for (int u = 0; u < 4; ++u) adagrad_element(a, lr, pf[u], gf[u], hf[u]);
      mta::store4(p + 4 * i, pf);
      mta::store4(h + 4 * i, hf);
    }
    i = 4 * nvec + threadIdx.x;       // the ragged tail, scalar
  }
  for (; i < k.len; i += mta::kThreads) {
    float pf = mta::to_float(p[i]), hf = h[i];
    adagrad_element(a, lr, pf, mta::to_float(g[i]), hf);
    p[i] = mta::from_float<T>(pf);
    h[i] = hf;
  }
}

template <typename T>
int run_adagrad(const Table& tab, const AdagradArgs& a, const float* lr_dev,
                const int* noop, cudaStream_t stream) {
  if (tab.n_chunks == 0) return 0;
  adagrad_chunks_kernel<T><<<static_cast<unsigned>(tab.n_chunks),
                             mta::kThreads, 0, stream>>>(tab, a, lr_dev,
                                                         noop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Stage 1 over a table of four lists (p, g, m, v).  gnorm: the device grad
// norm, or null for no clip.  scal: (lr, c1, c2), three floats on the card
// (stage 1 reads c1 and c2).  noop: null, or one int32 on the card; nonzero
// skips the step.  u: offsets[n_tensors] floats out.  partial: 2 * n_chunks
// floats of scratch.  sums: 2 * n_tensors floats out (||p||^2 then
// ||u||^2).  ratio: n_tensors floats out.  dtype is p's and g's.  Argument
// errors are negative; a launch error is the cudaError_t value.
extern "C" int apex_lamb_stage1(
    const void* ptrs, const void* offsets, const void* chunk_tensor,
    const void* chunk_start, const void* tensor_chunk0, int n_tensors,
    int n_chunks, int dtype, float beta1, float beta2, float eps,
    float weight_decay, float max_grad_norm, const void* gnorm,
    const void* scal, const void* noop, void* u, void* partial, void* sums,
    void* ratio, void* stream) {
  if (n_tensors < 1 || n_chunks < 0 || scal == nullptr) return -2;
  const Table tab = mta::make_table(ptrs, offsets, chunk_tensor, chunk_start,
                                    tensor_chunk0, n_tensors, n_chunks);
  const Lamb1Args a{beta1, beta2, eps, weight_decay, max_grad_norm};
  const float* gn = static_cast<const float*>(gnorm);
  const float* sd = static_cast<const float*>(scal);
  const int* nf = static_cast<const int*>(noop);
  float* uo = static_cast<float*>(u);
  float* pa = static_cast<float*>(partial);
  float* su = static_cast<float*>(sums);
  float* ra = static_cast<float*>(ratio);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_stage1<float>(tab, a, gn, sd, nf, uo, pa, su, ra, st);
    case 1:
      return run_stage1<__nv_bfloat16>(tab, a, gn, sd, nf, uo, pa, su, ra,
                                       st);
    case 2:
      return run_stage1<__half>(tab, a, gn, sd, nf, uo, pa, su, ra, st);
    default:
      return -1;
  }
}

// Stage 2 over the same table (list 0 = p is updated in place).  scal: the
// step's (lr, c1, c2) on the card (stage 2 reads lr); noop as stage 1's.
extern "C" int apex_lamb_stage2(const void* ptrs, const void* offsets,
                                const void* chunk_tensor,
                                const void* chunk_start,
                                const void* tensor_chunk0, int n_tensors,
                                int n_chunks, int dtype, const void* u,
                                const void* ratio, const void* scal,
                                const void* noop, void* stream) {
  if (n_tensors < 1 || n_chunks < 0 || scal == nullptr) return -2;
  const Table tab = mta::make_table(ptrs, offsets, chunk_tensor, chunk_start,
                                    tensor_chunk0, n_tensors, n_chunks);
  const float* uo = static_cast<const float*>(u);
  const float* ra = static_cast<const float*>(ratio);
  const float* sd = static_cast<const float*>(scal);
  const int* nf = static_cast<const int*>(noop);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_stage2<float>(tab, uo, ra, sd, nf, st);
    case 1:
      return run_stage2<__nv_bfloat16>(tab, uo, ra, sd, nf, st);
    case 2:
      return run_stage2<__half>(tab, uo, ra, sd, nf, st);
    default:
      return -1;
  }
}

// Adam over a table of four lists (p, g, m, v), p, m and v in place.
// dtype is p's and g's; adam_w_mode 1 is AdamW (decoupled decay), 0 Adam
// with the decay folded into the gradient.  scal: the step's (lr, c1, c2),
// three floats on the card.  noop: null, or one int32 on the card; nonzero
// skips the step.
extern "C" int apex_adam(const void* ptrs, const void* offsets,
                         const void* chunk_tensor, const void* chunk_start,
                         const void* tensor_chunk0, int n_tensors,
                         int n_chunks, int dtype, float beta1, float beta2,
                         float eps, float weight_decay, int adam_w_mode,
                         const void* scal, const void* noop, void* stream) {
  if (n_tensors < 1 || n_chunks < 0 || scal == nullptr) return -2;
  const Table tab = mta::make_table(ptrs, offsets, chunk_tensor, chunk_start,
                                    tensor_chunk0, n_tensors, n_chunks);
  const AdamArgs a{beta1, beta2, eps, weight_decay, adam_w_mode != 0};
  const float* sd = static_cast<const float*>(scal);
  const int* nf = static_cast<const int*>(noop);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_adam<float>(tab, a, sd, nf, st);
    case 1:
      return run_adam<__nv_bfloat16>(tab, a, sd, nf, st);
    case 2:
      return run_adam<__half>(tab, a, sd, nf, st);
    default:
      return -1;
  }
}

// Momentum SGD over a table of three lists (p, g, buf), p and buf in place.
// dtype is p's and g's.  lr_dev: null, or one float on the card that
// replaces lr.  noop: null, or one int32 on the card; nonzero skips the
// step.
extern "C" int apex_sgd(const void* ptrs, const void* offsets,
                        const void* chunk_tensor, const void* chunk_start,
                        const void* tensor_chunk0, int n_tensors,
                        int n_chunks, int dtype, float lr, float momentum,
                        float weight_decay, float dampening, int nesterov,
                        int first_step, const void* lr_dev, const void* noop,
                        void* stream) {
  if (n_tensors < 1 || n_chunks < 0) return -2;
  const Table tab = mta::make_table(ptrs, offsets, chunk_tensor, chunk_start,
                                    tensor_chunk0, n_tensors, n_chunks);
  const SgdArgs a{lr, momentum, weight_decay, dampening, nesterov != 0,
                  first_step != 0};
  const float* lr_d = static_cast<const float*>(lr_dev);
  const int* nf = static_cast<const int*>(noop);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_sgd<float>(tab, a, lr_d, nf, st);
    case 1:
      return run_sgd<__nv_bfloat16>(tab, a, lr_d, nf, st);
    case 2:
      return run_sgd<__half>(tab, a, lr_d, nf, st);
    default:
      return -1;
  }
}

// NovoGrad over a table of three lists (p, g, m), p and m in place, after
// the per-tensor kernel: sq (n_tensors floats in: the squared grad norms),
// v (n_tensors floats, in place), inv_denom (n_tensors floats out).  dtype
// is p's and g's.  scal: (lr_c1, c2), two floats on the card; step: one
// int32 on the card, the first step when 0; noop: null, or one int32 on
// the card, nonzero skips the step.
extern "C" int apex_novograd(
    const void* ptrs, const void* offsets, const void* chunk_tensor,
    const void* chunk_start, const void* tensor_chunk0, int n_tensors,
    int n_chunks, int dtype, float beta1, float beta2, float one_minus_beta2,
    float eps, float weight_decay, float grad_avg_coeff, int init_zero,
    const void* sq, void* v, void* inv_denom, const void* scal,
    const void* step, const void* noop, void* stream) {
  if (n_tensors < 1 || n_chunks < 0 || scal == nullptr || step == nullptr)
    return -2;
  const Table tab = mta::make_table(ptrs, offsets, chunk_tensor, chunk_start,
                                    tensor_chunk0, n_tensors, n_chunks);
  const NovoArgs a{beta1, beta2, one_minus_beta2, eps, weight_decay,
                   grad_avg_coeff, init_zero != 0};
  const float* s = static_cast<const float*>(sq);
  float* vv = static_cast<float*>(v);
  float* inv = static_cast<float*>(inv_denom);
  const float* sd = static_cast<const float*>(scal);
  const int* st = static_cast<const int*>(step);
  const int* nf = static_cast<const int*>(noop);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_novograd<float>(tab, a, s, vv, inv, sd, st, nf, strm);
    case 1:
      return run_novograd<__nv_bfloat16>(tab, a, s, vv, inv, sd, st, nf,
                                         strm);
    case 2:
      return run_novograd<__half>(tab, a, s, vv, inv, sd, st, nf, strm);
    default:
      return -1;
  }
}

// Adagrad over a table of three lists (p, g, h), p and h in place.  dtype
// is p's and g's; adagrad_w_mode 1 adds the decay to the update, 0 folds it
// into the gradient.  lr_dev and noop as apex_sgd's.
extern "C" int apex_adagrad(const void* ptrs, const void* offsets,
                            const void* chunk_tensor, const void* chunk_start,
                            const void* tensor_chunk0, int n_tensors,
                            int n_chunks, int dtype, float lr, float eps,
                            float weight_decay, int adagrad_w_mode,
                            const void* lr_dev, const void* noop,
                            void* stream) {
  if (n_tensors < 1 || n_chunks < 0) return -2;
  const Table tab = mta::make_table(ptrs, offsets, chunk_tensor, chunk_start,
                                    tensor_chunk0, n_tensors, n_chunks);
  const AdagradArgs a{lr, eps, weight_decay, adagrad_w_mode != 0};
  const float* lr_d = static_cast<const float*>(lr_dev);
  const int* nf = static_cast<const int*>(noop);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_adagrad<float>(tab, a, lr_d, nf, st);
    case 1:
      return run_adagrad<__nv_bfloat16>(tab, a, lr_d, nf, st);
    case 2:
      return run_adagrad<__half>(tab, a, lr_d, nf, st);
    default:
      return -1;
  }
}

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
