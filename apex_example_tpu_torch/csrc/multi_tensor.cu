// Multi-tensor sum of squares and scale for Hopper (sm_90a), bound with
// ctypes.
//
// Replaces apex_example_tpu/ops/multi_tensor.py:203 `_sqsum_kernel` (the
// Pallas kernel launched once per leaf by `_sqsum_leaf_pallas`, :214 /
// :223) and the cross-leaf combine of `multi_tensor_l2norm` (:248):
// per-tensor fp32 sums of x*x, and the global norm sqrt(sum over tensors).
//
// Bound: bytes.  Every element is read once (4 bytes in fp32) and the work
// is two operations per element, so the least time is the bytes over the
// card's 3.35 TB/s: 109.5 M grad elements of bert_base, 438 MB, ~0.131 ms.
//
// Design.  The TPU kernel carries one sum across the grid steps of a leaf,
// which run in order there; on the GPU blocks run concurrently.  So the
// whole list goes in ONE launch of one block per 64 Ki-element chunk (the
// chunk table of multi_tensor_apply.cuh), each block writes its chunk's
// partial sum, a warp per tensor adds that tensor's partials in chunk order,
// and one block adds the per-tensor sums.  No float atomics: two runs give
// bitwise-identical results.  Loads are scalar and coalesced, four in
// flight per thread; any float dtype, one dtype per list.
//
// Multi-tensor scale.  Replaces apex_example_tpu/ops/multi_tensor.py:79
// `_scale_kernel` (launched once per leaf by `_scale_leaf_pallas`, :93 /
// :103) and the cross-leaf flag of `multi_tensor_scale` (:125): y = x * s in
// fp32, stored in x's dtype, and a flag raised when any INPUT element is
// inf or nan, whatever the scale.  s is a host float, or the clip scale
// min(1, max_norm / (norm + eps)) of `clip_grad_norm` (:265-272), which each
// block computes from the global norm the sum-of-squares launch left on the
// card: no host sync sits between the norm and the scale.  For the loss
// scaler's unscale (amp/scaler.py, port of amp/scaler.py:90-111) s is read
// from the card (1 / scale, the dynamic scale never crosses to the host)
// and the flag is raised by a non-finite OUTPUT element, as the JAX
// package's all_finite of the unscaled grads: that covers the inputs that
// are inf or nan and a product that overflows the grads' dtype.
//
// Bound: bytes.  x read once and y written once, 8 bytes per fp32 element:
// Transformer-XL's 150.9 M grads are 1.21 GB, ~0.36 ms at 3.35 TB/s.
//
// Design: one block per 64 Ki-element chunk over the whole list in one
// launch, 16-byte vector loads and stores where every pointer of the chunk
// is 16-byte aligned (else scalar ones), in place when the out list is the
// in list.  The flag is one int32 that the entry point zeroes on the stream;
// a block ORs 1 into it (an integer atomic) when __syncthreads_or finds a
// non-finite element among its threads.  The TPU kernel's per-leaf SMEM
// counter becomes that one word.
//
// axpby.  Replaces apex_example_tpu/ops/multi_tensor.py:151 `_axpby_kernel`
// (launched once per leaf by `_axpby_leaf_pallas`, :157 / :170, from the
// public `multi_tensor_axpby` :188): out = a*x + b*y in fp32, stored in y's
// dtype.  x and y may differ in dtype (any pair of fp32, bf16 and fp16:
// apex mixes half model grads with fp32 masters), so the kernel is
// instantiated for each pair; a and b are host floats.  Bound: bytes.  x and
// y read once, out written once: 12 bytes per fp32 element, bert_base's
// 109.5 M elements 1.31 GB, ~0.392 ms at 3.35 TB/s; three operations per
// element.  Design: one block per 64 Ki-element chunk over the whole list in
// one launch (a table of three lists: x, y, out), 16-byte vector loads
// where every pointer of the chunk is 16-byte aligned, scalar otherwise.

#include "multi_tensor_apply.cuh"

namespace {

using mta::Chunk;
using mta::Table;

// Scale of one launch: the host value, the value on the card, or the clip
// scale from the device norm.  NaN propagates, as jnp.minimum does.
__device__ __forceinline__ float scale_of(float scale, const float* scale_dev,
                                          const float* norm, float max_norm,
                                          float eps) {
  if (scale_dev != nullptr) return scale_dev[0];
  if (norm == nullptr) return scale;
  const float r = max_norm / (norm[0] + eps);
  return r > 1.f ? 1.f : r;
}

template <typename T>
__global__ void __launch_bounds__(mta::kThreads)
    scale_chunks_kernel(Table tab, int in_list, int out_list, float scale,
                        const float* __restrict__ scale_dev,
                        const float* __restrict__ norm, float max_norm,
                        float eps, int flag_output, int* __restrict__ flag) {
  const Chunk k = mta::chunk_of(tab, blockIdx.x);
  const long long n = tab.n_tensors;
  const T* x =
      reinterpret_cast<const T*>(tab.ptrs[in_list * n + k.tensor]) + k.start;
  T* y = reinterpret_cast<T*>(tab.ptrs[out_list * n + k.tensor]) + k.start;
  const float s = scale_of(scale, scale_dev, norm, max_norm, eps);
  bool bad = false;
  int i = threadIdx.x;
  if (mta::aligned16(x) && mta::aligned16(y)) {
    const int nvec = k.len / 4;
    for (; i < nvec; i += mta::kThreads) {
      float v[4];
      mta::load4(x + 4 * i, v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!flag_output) bad |= !isfinite(v[u]);
        v[u] *= s;
        if (flag_output)
          bad |= !isfinite(mta::to_float(mta::from_float<T>(v[u])));
      }
      mta::store4(y + 4 * i, v);
    }
    i = 4 * nvec + threadIdx.x;       // the ragged tail, scalar
  }
  for (; i < k.len; i += mta::kThreads) {
    const float v = mta::to_float(x[i]);
    const T out = mta::from_float<T>(v * s);
    bad |= !isfinite(flag_output ? mta::to_float(out) : v);
    y[i] = out;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

template <typename T>
__global__ void __launch_bounds__(mta::kThreads)
    sqsum_chunks_kernel(Table tab, int list, float* __restrict__ partial) {
  __shared__ float smem[mta::kThreads / 32];
  const Chunk k = mta::chunk_of(tab, blockIdx.x);
  const T* x = reinterpret_cast<const T*>(
                   tab.ptrs[static_cast<long long>(list) * tab.n_tensors +
                            k.tensor]) +
               k.start;
  float acc = 0.f;
  for (int base = threadIdx.x; base < k.len;
       base += mta::kUnroll * mta::kThreads) {
    float v[mta::kUnroll];
#pragma unroll
    for (int u = 0; u < mta::kUnroll; ++u) {
      const int i = base + u * mta::kThreads;
      v[u] = i < k.len ? mta::to_float(x[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < mta::kUnroll; ++u) acc += v[u] * v[u];
  }
  acc = mta::block_sum(acc, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// One block: norm[0] = sqrt(sum of sq[t]) over the tensors, in a fixed order.
__global__ void __launch_bounds__(mta::kThreads)
    global_norm_kernel(const float* __restrict__ sq, int n_tensors,
                       float* __restrict__ norm) {
  __shared__ float smem[mta::kThreads / 32];
  float s = 0.f;
  for (int t = threadIdx.x; t < n_tensors; t += mta::kThreads) s += sq[t];
  s = mta::block_sum(s, smem);
  if (threadIdx.x == 0) norm[0] = sqrtf(s);
}

template <typename T>
int run(const Table& tab, int list, float* partial, float* sq, float* norm,
        cudaStream_t stream) {
  if (tab.n_chunks > 0) {
    sqsum_chunks_kernel<T><<<static_cast<unsigned>(tab.n_chunks),
                             mta::kThreads, 0, stream>>>(tab, list, partial);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  int rc = mta::launch_tensor_sums(tab, 1, partial, sq, stream);
  if (rc != 0) return rc;
  global_norm_kernel<<<1, mta::kThreads, 0, stream>>>(sq, tab.n_tensors,
                                                      norm);
  return static_cast<int>(cudaGetLastError());
}

// ptrs lists: 0 = x (dtype TX), 1 = y, 2 = out (dtype TY).
template <typename TX, typename TY>
__global__ void __launch_bounds__(mta::kThreads)
    axpby_chunks_kernel(Table tab, float a, float b) {
  const Chunk k = mta::chunk_of(tab, blockIdx.x);
  const long long n = tab.n_tensors;
  const TX* x = reinterpret_cast<const TX*>(tab.ptrs[k.tensor]) + k.start;
  const TY* y = reinterpret_cast<const TY*>(tab.ptrs[n + k.tensor]) + k.start;
  TY* out = reinterpret_cast<TY*>(tab.ptrs[2 * n + k.tensor]) + k.start;
  int i = threadIdx.x;
  if (mta::aligned16(x) && mta::aligned16(y) && mta::aligned16(out)) {
    const int nvec = k.len / 4;
    for (; i < nvec; i += mta::kThreads) {
      float xf[4], yf[4];
      mta::load4(x + 4 * i, xf);
      mta::load4(y + 4 * i, yf);
#pragma unroll
      for (int u = 0; u < 4; ++u) xf[u] = a * xf[u] + b * yf[u];
      mta::store4(out + 4 * i, xf);
    }
    i = 4 * nvec + threadIdx.x;       // the ragged tail, scalar
  }
  for (; i < k.len; i += mta::kThreads)
    out[i] = mta::from_float<TY>(a * mta::to_float(x[i]) +
                                 b * mta::to_float(y[i]));
}

template <typename TX, typename TY>
int run_axpby(const Table& tab, float a, float b, cudaStream_t stream) {
  if (tab.n_chunks == 0) return 0;
  axpby_chunks_kernel<TX, TY><<<static_cast<unsigned>(tab.n_chunks),
                                mta::kThreads, 0, stream>>>(tab, a, b);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int run_axpby_y(const Table& tab, int y_dtype, float a, float b,
                cudaStream_t stream) {
  switch (y_dtype) {
    case 0:
      return run_axpby<TX, float>(tab, a, b, stream);
    case 1:
      return run_axpby<TX, __nv_bfloat16>(tab, a, b, stream);
    case 2:
      return run_axpby<TX, __half>(tab, a, b, stream);
    default:
      return -1;
  }
}

template <typename T>
int run_scale(const Table& tab, int in_list, int out_list, float scale,
              const float* scale_dev, const float* norm, float max_norm,
              float eps, int flag_output, int* flag, cudaStream_t stream) {
  int rc = static_cast<int>(cudaMemsetAsync(flag, 0, sizeof(int), stream));
  if (rc != 0 || tab.n_chunks == 0) return rc;
  scale_chunks_kernel<T><<<static_cast<unsigned>(tab.n_chunks),
                           mta::kThreads, 0, stream>>>(
      tab, in_list, out_list, scale, scale_dev, norm, max_norm, eps,
      flag_output, flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: ptrs, offsets, chunk_tensor, chunk_start, tensor_chunk0 as laid
// out in multi_tensor_apply.cuh.  partial: n_chunks floats of scratch.
// sq: n_tensors floats out; norm: 1 float out.  Argument errors are
// negative; a launch error is the cudaError_t value.
extern "C" int apex_multi_tensor_sqsum(
    const void* ptrs, const void* offsets, const void* chunk_tensor,
    const void* chunk_start, const void* tensor_chunk0, int n_tensors,
    int n_chunks, int list, int dtype, void* partial, void* sq, void* norm,
    void* stream) {
  if (n_tensors < 1 || n_chunks < 0 || list < 0) return -2;
  const Table tab = mta::make_table(ptrs, offsets, chunk_tensor, chunk_start,
                                    tensor_chunk0, n_tensors, n_chunks);
  float* p = static_cast<float*>(partial);
  float* s = static_cast<float*>(sq);
  float* n = static_cast<float*>(norm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run<float>(tab, list, p, s, n, st);
    case 1:
      return run<__nv_bfloat16>(tab, list, p, s, n, st);
    case 2:
      return run<__half>(tab, list, p, s, n, st);
    default:
      return -1;
  }
}

// y = x * s from list in_list to list out_list of the table (the same list:
// in place), both of dtype `dtype`.  s = scale_dev[0] when scale_dev is not
// null, else min(1, max_norm / (norm[0] + eps)) read on the card when norm
// is not null, else scale.  flag: one int32 out, 1 when some input element
// (flag_output 0) or some output element (flag_output 1) is inf or nan,
// else 0.
extern "C" int apex_multi_tensor_scale(
    const void* ptrs, const void* offsets, const void* chunk_tensor,
    const void* chunk_start, const void* tensor_chunk0, int n_tensors,
    int n_chunks, int in_list, int out_list, int dtype, float scale,
    const void* scale_dev, const void* norm, float max_norm, float eps,
    int flag_output, void* flag, void* stream) {
  if (n_tensors < 1 || n_chunks < 0 || in_list < 0 || out_list < 0)
    return -2;
  const Table tab = mta::make_table(ptrs, offsets, chunk_tensor, chunk_start,
                                    tensor_chunk0, n_tensors, n_chunks);
  const float* sd = static_cast<const float*>(scale_dev);
  const float* nm = static_cast<const float*>(norm);
  int* fl = static_cast<int*>(flag);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_scale<float>(tab, in_list, out_list, scale, sd, nm,
                              max_norm, eps, flag_output, fl, st);
    case 1:
      return run_scale<__nv_bfloat16>(tab, in_list, out_list, scale, sd, nm,
                                      max_norm, eps, flag_output, fl, st);
    case 2:
      return run_scale<__half>(tab, in_list, out_list, scale, sd, nm,
                               max_norm, eps, flag_output, fl, st);
    default:
      return -1;
  }
}

// out = a * x + b * y over a table of three lists (x, y, out): x of dtype
// x_dtype, y and out of y_dtype.
extern "C" int apex_multi_tensor_axpby(
    const void* ptrs, const void* offsets, const void* chunk_tensor,
    const void* chunk_start, const void* tensor_chunk0, int n_tensors,
    int n_chunks, int x_dtype, int y_dtype, float a, float b, void* stream) {
  if (n_tensors < 1 || n_chunks < 0) return -2;
  const Table tab = mta::make_table(ptrs, offsets, chunk_tensor, chunk_start,
                                    tensor_chunk0, n_tensors, n_chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return run_axpby_y<float>(tab, y_dtype, a, b, st);
    case 1:
      return run_axpby_y<__nv_bfloat16>(tab, y_dtype, a, b, st);
    case 2:
      return run_axpby_y<__half>(tab, y_dtype, a, b, st);
    default:
      return -1;
  }
}

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
