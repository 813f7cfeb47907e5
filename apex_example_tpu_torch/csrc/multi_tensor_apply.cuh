// Tensor-list launches for Hopper (sm_90a): the pieces multi_tensor.cu and
// fused_optim.cu share.
//
// apex's multi_tensor_apply cuts a LIST of tensors into fixed-size chunks
// and covers the whole list in one launch: one block per chunk.  Here the
// chunk table lives in device memory, built once on the host
// (ops/multi_tensor.py TensorTable) from the tensors' addresses, which stay
// put across steps:
//
//   ptrs[l * n_tensors + t]   address of tensor t of list l
//   offsets[t]                flat element offset of tensor t (prefix sum of
//                             numel; offsets[n_tensors] is the total)
//   chunk_tensor[c]           the tensor chunk c belongs to
//   chunk_start[c]            chunk c's first element inside that tensor
//   tensor_chunk0[t]          tensor t's first chunk (tensor_chunk0[n] = C)
//
// Sums across blocks are never carried by float atomics: each block writes
// its chunk's partial sum, and a second pass adds a tensor's partials in
// chunk order.  Every reduction has a fixed shape, so two runs on the same
// inputs give bitwise-identical sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mta {

constexpr int kChunk = 65536;   // elements per chunk (apex's chunk size)
constexpr int kThreads = 512;   // threads per chunk block
constexpr int kUnroll = 4;      // loads in flight per thread

struct Table {
  const long long* ptrs;
  const long long* offsets;
  const long long* chunk_tensor;
  const long long* chunk_start;
  const long long* tensor_chunk0;
  int n_tensors;
  int n_chunks;
};

// The Table of the five pointers of an entry point's C interface.
inline Table make_table(const void* ptrs, const void* offsets,
                        const void* chunk_tensor, const void* chunk_start,
                        const void* tensor_chunk0, int n_tensors,
                        int n_chunks) {
  return Table{static_cast<const long long*>(ptrs),
               static_cast<const long long*>(offsets),
               static_cast<const long long*>(chunk_tensor),
               static_cast<const long long*>(chunk_start),
               static_cast<const long long*>(tensor_chunk0), n_tensors,
               n_chunks};
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

// Four neighbouring elements in one load or store: 16 bytes of fp32, 8 of
// bf16 or fp16.  Callers check alignment first (aligned16).
template <typename T>
struct Vec4 {
  using type = uint2;
};
template <>
struct Vec4<float> {
  using type = float4;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&out)[4]) {
  const typename Vec4<T>::type raw =
      *reinterpret_cast<const typename Vec4<T>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) out[u] = to_float(e[u]);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&in)[4]) {
  typename Vec4<T>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) e[u] = from_float<T>(in[u]);
  *reinterpret_cast<typename Vec4<T>::type*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over a whole block of kThreads threads, in a fixed order; thread 0
// gets the total.  smem holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? smem[lane] : 0.f;
    v = warp_sum(v);
  }
  __syncthreads();  // smem is written again by the next reduction
  return v;
}

// Chunk c of the table: its tensor, its first element inside that tensor,
// its length and the tensor's flat offset.
struct Chunk {
  int tensor;
  long long start;
  int len;
  long long flat;
};

__device__ __forceinline__ Chunk chunk_of(const Table& tab, int c) {
  Chunk k;
  k.tensor = static_cast<int>(tab.chunk_tensor[c]);
  k.start = tab.chunk_start[c];
  k.flat = tab.offsets[k.tensor];
  const long long numel = tab.offsets[k.tensor + 1] - k.flat;
  const long long left = numel - k.start;
  k.len = static_cast<int>(left < kChunk ? left : kChunk);
  return k;
}

// Second pass: per-tensor sums of K per-chunk partials (partial[k * C + c]),
// one warp per tensor; lanes take the tensor's chunks in strides of 32 and
// the warp adds them in a fixed tree.  out[k * n_tensors + t] = the sum.
// noop: null, or one int32 on the card; nonzero returns before any write
// (a skipped optimizer step, whose first pass wrote no partial).
template <int K>
__global__ void __launch_bounds__(256)
    tensor_sums_kernel(Table tab, const float* __restrict__ partial,
                       float* __restrict__ out, const int* __restrict__ noop) {
  if (noop != nullptr && *noop != 0) return;
  const int t = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= tab.n_tensors) return;
  const int c0 = static_cast<int>(tab.tensor_chunk0[t]);
  const int c1 = static_cast<int>(tab.tensor_chunk0[t + 1]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int c = c0 + lane; c < c1; c += 32)
      s += partial[static_cast<long long>(k) * tab.n_chunks + c];
    s = warp_sum(s);
    if (lane == 0) out[static_cast<long long>(k) * tab.n_tensors + t] = s;
  }
}

inline int launch_tensor_sums(const Table& tab, int k, const float* partial,
                              float* out, cudaStream_t stream,
                              const int* noop = nullptr) {
  const unsigned blocks = static_cast<unsigned>((tab.n_tensors + 7) / 8);
  if (k == 1)
    tensor_sums_kernel<1><<<blocks, 256, 0, stream>>>(tab, partial, out,
                                                      noop);
  else
    tensor_sums_kernel<2><<<blocks, 256, 0, stream>>>(tab, partial, out,
                                                      noop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mta
