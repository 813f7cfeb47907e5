// Multi-tensor sum of squares for Hopper (sm_90a), bound with ctypes.
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

#include "multi_tensor_apply.cuh"

namespace {

using mta::Chunk;
using mta::Table;

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
  Table tab{static_cast<const long long*>(ptrs),
            static_cast<const long long*>(offsets),
            static_cast<const long long*>(chunk_tensor),
            static_cast<const long long*>(chunk_start),
            static_cast<const long long*>(tensor_chunk0), n_tensors,
            n_chunks};
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

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
