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
// Bound: operations.  Each live score costs 4 (forward), 8 (dK/dV) and 6
// (dQ) flops per head-dimension element, and the bytes are O(S * D) per
// head, so at gpt_base's 8 x 2048 x 12 x 64 the least time is the flops
// over the card's fp32 rate, or its bf16 / fp16 tensor-core rate for half
// inputs.
//
// Two designs, chosen by dtype alone (`launch`); no shape and no failure
// sends a tensor to the other one:
//
// fp32: fp32 fused multiply-adds on the CUDA cores for all three (fp32
// without TF32 is the port's fp32 contract; P and dS round to fp32, so
// those roundings are none).  Causal tiles wholly above the diagonal are
// skipped, as `_when_live` (:121) skips them.
//
// The fp32 kernels (`attn_fwd_kernel`, `attn_dkdv_kernel`,
// `attn_dq_kernel`) are SIMT GEMM.  Their bound is the fp32 FMA rate: 4
// (forward), 8 (dK/dV) and 6 (dQ) flops per live score and head-dim
// element, 0.77, 1.54 and 1.15 ms at gpt_base's 8 x 2048 x 12 x 64 causal
// over 67 TFLOP/s.  Three things keep a simple kernel far from it, and the
// design answers each:
// - Shared-memory bandwidth.  A 4 x 4 register tile reads a float for
//   every two FMAs, and an SM's shared memory gives 32 floats a clock
//   against 128 FMAs.  Here a thread holds 8 x 8 tiles (8 x 3 for the
//   score products at D 128, where shared memory runs out; 4 x 8 for
//   dQ's row product, below): 4 FMAs per float read, every read a 16-byte
//   load that a warp takes without a bank conflict.  The stationary
//   operand of the products over the head dim (S = Q K^T, dP = dO V^T) is
//   stored d-major (Q^T in the forward; K^T, V^T in dK/dV; Q^T, dO^T in
//   dQ), the streamed one row-major with rows 4 floats past the padded
//   head dim apart; the products over rows (O += P V, dV += P^T dO, dK +=
//   dS^T Q, dQ += dS K) read P and dS from a [col][row] tile and the
//   streamed tile row-major.
// - Synchronous loads.  The streamed tiles (K, V and the key bias in the
//   forward and dQ; Q, dO, lse and Delta in dK/dV) run through a two-stage
//   cp.async ring, the next tile in flight while the block computes:
//   16-byte copies when `vq/vk/vv/vdo` say the rows are contiguous and
//   aligned (the models' (B, L, H, D) views), else 4-byte copies through
//   the strides into the same layout.  The stationary tiles load once a
//   block, behind the first tile's copies.
// - Occupancy and order.  A thread's register tiles take 168-255
//   registers at D 64, so a block is one per SM: 256 threads, two groups of
//   128 that run two products of each step side by side.  The forward: 128
//   queries a block (64 at D 128) against k/v tiles of 64 (48), pipelined
//   over the tiles: at step t group 0 sums S = Q K^T of tile t and runs the
//   online softmax (row max, alpha = exp(m_old - m_new), P, l), while group
//   1 rescales O by tile t - 1's alpha and adds its P V; each group has a
//   loop of its own, so O's registers live in group 1's code only (255
//   registers with one loop, 168 with two), and one barrier a step.  dK/dV:
//   128 keys a block (64 at D 128) against q tiles of 64 (48); group 0 sums
//   S^T = K Q^T, then dV, group 1 dP^T = V dO^T, then dK.  dQ: 128 queries
//   (64) against k/v tiles of 64 (48); group 0 sums S = Q K^T, group 1 dP =
//   dO V^T, and each then sums dQ for half of the queries (4 x 8 tiles,
//   2.67 FMAs a float).  Between the products every thread turns its share
//   of the tile's pairs into P and dS in shared memory (in dQ from the raw
//   dots), so both groups share the exp.  Causal blocks launch longest
//   first.  No atomics, and every output element is one fused multiply-add
//   chain in order (the forward's O rescaled between tiles): fp32 dQ, dK
//   and dV come out bitwise equal to the plain version, whose matrix
//   products on the card sum in that order, and a second launch repeats
//   bitwise.  ptxas: the forward 168 / 139 registers at D 64 / 128, dK/dV
//   255 / 165, dQ 229 / 161, no spill.
//
// bf16 and fp16: Hopper's tensor cores for all three (`*_kernel_tc`).
// One warpgroup (128 threads) owns 64 rows: queries in the forward and in
// dQ, keys in dK/dV.  Every operand tile is 64 rows of the head dim padded
// to 64 or 128 elements (pad columns zero), stored in wgmma's 128-byte-
// swizzle layout, so one tile serves as a K-major operand (the products
// over the head dim: S = Q K^T, dP = dO V^T and their transposes) and as
// a transposed, MN-major one (the products over rows: P V, dS K, P^T dO,
// dS^T Q).  The streamed tiles (K and V in the forward and dQ; Q, dO, lse
// and Delta in dK/dV) run through a ring of two stages filled by cp.async
// while the previous tile computes; cp.async, not TMA, because the
// operands arrive as strided (B, S, H, D) views with any strides: a row
// that is contiguous and 16-byte aligned loads in 16-byte chunks, any other
// through its strides, element by element, into the same layout.  The
// score-shaped products are shared-memory wgmma (m64n64k16); the softmax,
// P and dS run on the fp32 accumulator fragments, each thread holding two
// rows; P and dS are rounded into the register A operand of the next
// product (m64n64k16 or m64n128k16, the B tile read MN-major).  The
// backward's tensor cores accumulate straight into S, dP, dQ, dK and dV
// (fresh per-k16 partials added with round-to-nearest were slower and
// passed nothing more: PERF.md).  Key tiles stay 64 wide (kTcKeys), so a
// half O rounds P against the running max where
// attention_pair_tiled_plain does.  Causal blocks launch longest first.
//
// The tensor cores add the same fp32 products as the plain version in
// another order, so a half result is not bitwise the plain version's.  It
// is held to ops/attention.py's `half_result_check`: every element within
// about two ulps (rtol 1e-2, atol 1e-3), at most 1e-2 (bf16) or 8e-2
// (fp16, 3 more mantissa bits, 8 x the flips) of the elements off at all;
// in a batch element whose key bias masks every key, each row within 3 x
// the plain version's own distance from correctly rounded sums.  A
// rounding point skipped or moved flips 39-55% of the elements.  The
// atol has no floor outside dead rows, and one rounding of P or dS that
// flips at a pair where P or |dS| is large (at least flip_limit: 1/64 in
// bf16, 1/8 in fp16) moves a whole row of dV, dK or dQ by an ulp of P or
// dS times an operand, up to ~4e-3: past it where the row's elements
// cancel near zero.  Correctly rounded sums do that too, against the
// plain version, on a peaked softmax; in a dead row (P = 1 at every key)
// dS is unnormalised at every key.  So the backward kernels take the S and
// dP of a large pair whose P or dS lies near a rounding tie of the input
// dtype again with the CUDA-core kernels' fp32 FMA chain (`plain_pairs`),
// which the plain version on the card matches bitwise: their P and dS
// round where the plain version's do.  Every other pair keeps the tensor
// cores' values: far from a tie they round the same, and a small P or dS
// that flips moves an output by at most 2^-14 times an operand.

// Layout: q, k, v, o and dO are read in their (B, S, H, D) layout through
// four strides each (elements), so no transpose is copied; O, dQ, dK and
// dV are written contiguous (B, S, H, D); lse and Delta are contiguous
// (B, H, Sq) fp32.  Any Sq, Sk (tail tiles masked); D a multiple of 8 up
// to kMaxD.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;  // last_kv_tile's keys; a sequence is <= 65535 tiles
constexpr int kMaxD = 128;
constexpr float kMask = -0.7f * 3.402823466e38f;  // attention.py:60

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
  int vq, vk, vv, vdo;  // rows contiguous, 16-byte aligned (cp.async)
  int B, H, Sq, Sk, D;
  int causal, off;  // off = Sk - Sq
  float scale;
};

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

// ---- bf16 / fp16 on the tensor cores -------------------------------------

constexpr int kTcKeys = 64;      // keys of a k/v tile (the plain TILE)
constexpr int kTcRows = 64;      // rows of every other tile: q, dO
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kAtomBytes = 64 * 128;  // a 64-row column of 64 halves
static_assert(kTcKeys == kTcRows, "the tile helpers take 64-row tiles");

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Byte offset of 16-byte chunk c (halves 8c .. 8c + 7) of row r in a
// 64-row tile: columns of 64 halves (kAtomBytes apart), rows of 128 bytes,
// chunk c & 7 stored at (c & 7) ^ (r & 7) (the 128-byte swizzle, which
// the descriptors name; the tile base is 1024-byte aligned).
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return (c >> 3) * kAtomBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading byte offset, stride byte offset 1024 (eight 128-byte rows).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// The tile as a K-major operand (the product runs over the head dim),
// k16 step kk: 32 bytes along a row, the next column of 64 halves after 4.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kAtomBytes + (kk & 3) * 32, 16);
}
// The tile as an MN-major (transposed) operand (the product runs over its
// rows), k16 step kk: rows 16 kk .. 16 kk + 15; columns kAtomBytes apart.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, kAtomBytes);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for all but the newest cp.async group, then make the tiles visible
// to the tensor cores (the async proxy) and to the whole block.
__device__ __forceinline__ void wait_tiles() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}
__device__ __forceinline__ void st_shared_v4(uint32_t dst, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src));
  return v;
}
__device__ __forceinline__ void zero_smem(uint32_t dst, int bytes) {
  for (int i = 16 * threadIdx.x; i < bytes; i += 16 * kTcThreads)
    st_shared_v4(dst + i, 0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers that a wgmma reads or writes to this point of the
// program: the compiler may not move their other uses across it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The wgmma operand lists: a thread's 32 or 64 accumulator floats d[]
// and their PTX names.
#define APEX_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define APEX_D32 APEX_D8(0), APEX_D8(8), APEX_D8(16), APEX_D8(24)
#define APEX_D64 APEX_D32, APEX_D8(32), APEX_D8(40), APEX_D8(48), APEX_D8(56)
#define APEX_N32                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                \
  "%8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, "        \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define APEX_N64                                    \
  APEX_N32 ", "                                     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "        \
  "%40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, "        \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// One asm body per shape; TY is the operands' wgmma type, "bf16" or "f16".
// S (+)= A B^T, m64n64k16: A and B both K-major in shared memory
// (descriptors da, db); scale_d = 0 overwrites d.
#define APEX_WGMMA_SS(TY)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"             \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY \
               " {" APEX_N32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"        \
               : APEX_D32                                              \
               : "l"(da), "l"(db), "r"(scale_d))
// d (+)= A B, m64n64k16: A from registers (four 16-bit pairs a thread),
// B an MN-major (transposed) shared-memory operand.
#define APEX_WGMMA_RS64(TY)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " {" APEX_N32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n" \
               "}\n"                                                      \
               : APEX_D32                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(scale_d))
// d (+)= A B, m64n128k16: as above, 128 columns.
#define APEX_WGMMA_RS128(TY)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY   \
               " {" APEX_N64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n" \
               "}\n"                                                      \
               : APEX_D64                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    APEX_WGMMA_SS("f16");
  else
    APEX_WGMMA_SS("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    APEX_WGMMA_RS64("f16");
  else
    APEX_WGMMA_RS64("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    APEX_WGMMA_RS128("f16");
  else
    APEX_WGMMA_RS128("bf16");
}

// Two floats rounded to T, the lower column in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// A k16 slice of the 64 x 64 score accumulator as a wgmma A operand: the
// accumulator's n8 blocks 2 kk and 2 kk + 1 are the operand's columns
// 0-7 and 8-15, in the same thread and row.
template <typename T>
__device__ __forceinline__ void to_operand(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// This thread's share of the 16-byte chunks of a 64-row tile, D / 8
// chunks a row: chunks tid, tid + 128, ... in row-major order (rows r, c
// the first's), walked without a division per chunk.
struct ChunkWalk {
  int r, c, n;   // the first chunk's row and column; the thread's count
  int dr, dc;    // 128 chunks on: dr rows and dc columns further
  int cpr;       // chunks a row
};

__device__ __forceinline__ ChunkWalk chunk_walk(int D) {
  ChunkWalk w;
  w.cpr = D >> 3;
  const int total = kTcRows * w.cpr;
  const int t = threadIdx.x;
  w.r = t / w.cpr;
  w.c = t - w.r * w.cpr;
  w.n = t < total ? (total - t + kTcThreads - 1) / kTcThreads : 0;
  w.dr = kTcThreads / w.cpr;
  w.dc = kTcThreads - w.dr * w.cpr;
  return w;
}

// Start copying rows row0 .. row0 + 63 of head (b, h) of a (B, S, H, D)
// tensor into the tile at shared address `tile`: 16-byte cp.async chunks
// when the rows are contiguous and 16-byte aligned (`vec`), else 2-byte
// loads through the strides.  Rows at or past n_rows are zero; the pad
// columns past D are never written (zeroed at the kernel's start).
template <typename T>
__device__ __forceinline__ void load_tile_tc(uint32_t tile, const T* src,
                                             const long long* st, int vec,
                                             int b, int h, int row0,
                                             int n_rows, const ChunkWalk& w) {
  const long long base = b * st[0] + h * st[2];
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  int r = w.r, c = w.c;
  for (int i = 0; i < w.n; ++i) {
    const int row = row0 + r;
    const uint32_t dst = tile + chunk_off(r, c);
    if (vec) {
      const int safe = row < n_rows ? row : n_rows - 1;
      cp_async16(dst, src + base + safe * st[1] + 8 * c,
                 row < n_rows ? 16 : 0);
    } else {
      uint32_t u[4] = {0u, 0u, 0u, 0u};
      if (row < n_rows) {
        const long long at = base + row * st[1] + 8LL * c * st[3];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          u[e] = static_cast<uint32_t>(s16[at + 2 * e * st[3]]) |
                 (static_cast<uint32_t>(s16[at + (2 * e + 1) * st[3]]) << 16);
      }
      st_shared_v4(dst, u[0], u[1], u[2], u[3]);
    }
    r += w.dr;
    c += w.dc;
    if (c >= w.cpr) {
      c -= w.cpr;
      ++r;
    }
  }
}

// Start copying lse and Delta of rows q0 .. q0 + 63 (zero past Sq) to
// dst[0 .. 63] and dst[64 .. 127] (floats).
__device__ __forceinline__ void load_rows_tc(uint32_t dst, const Params& p,
                                             long long row_base, int q0) {
  const int t = threadIdx.x & 63;
  const float* src = threadIdx.x < 64 ? p.lse : p.delta;
  const int row = q0 + t;
  cp_async4(dst + 4 * threadIdx.x,
            src + row_base + (row < p.Sq ? row : p.Sq - 1),
            row < p.Sq ? 4 : 0);
}

// Rows r and r + 8 of a 64 x 2N accumulator in the input dtype: columns
// below D of rows row0 + r (+ 8) that are below n_rows, contiguous
// (B, n_rows, H, D).
template <typename T, int N>
__device__ __forceinline__ void store_acc(T* dst, const Params& p, int b,
                                          int h, int row0, int n_rows,
                                          int r, int c, const float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    if (row >= n_rows) continue;
    T* out = dst + ((static_cast<long long>(b) * n_rows + row) * p.H + h) *
                       p.D;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < p.D)
        *reinterpret_cast<uint32_t*>(out + col) =
            pack2<T>(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
    }
  }
}

// acc = acc * alpha + t, rounded after each step as the plain version's
// `acc * alpha + P V` is (no fused multiply-add).
template <int N>
__device__ __forceinline__ void rescale_add(float (&acc)[N],
                                            const float (&t)[N],
                                            const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha[(i >> 1) & 1]), t[i]);
}

// The 16 bits of a T (the low half of `bits`) widened to fp32.
template <typename T>
__device__ __forceinline__ float widen(uint32_t bits) {
  if constexpr (std::is_same<T, __half>::value)
    return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
  else
    return __uint_as_float(bits << 16);
}

// Row r1 of tile a1 dotted with row r2 of tile b1, and the same rows of a2
// and b2, over the head dim, in fp32 with one fused multiply-add per column
// in order: the CUDA-core kernels' chain, which the plain version on the
// card matches bitwise.  The two chains run interleaved.
template <typename T>
__device__ void dot_rows2(uint32_t a1, uint32_t b1, uint32_t a2, uint32_t b2,
                          int r1, int r2, int D, float& s1, float& s2) {
  s1 = s2 = 0.f;
  for (int c = 0; c < D / 8; ++c) {
    const uint4 x1 = ld_shared_v4(a1 + chunk_off(r1, c));
    const uint4 y1 = ld_shared_v4(b1 + chunk_off(r2, c));
    const uint4 x2 = ld_shared_v4(a2 + chunk_off(r1, c));
    const uint4 y2 = ld_shared_v4(b2 + chunk_off(r2, c));
    const uint32_t u1[4] = {x1.x, x1.y, x1.z, x1.w};
    const uint32_t v1[4] = {y1.x, y1.y, y1.z, y1.w};
    const uint32_t u2[4] = {x2.x, x2.y, x2.z, x2.w};
    const uint32_t v2[4] = {y2.x, y2.y, y2.z, y2.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 32; h += 16) {
        s1 = fmaf(widen<T>((u1[i] >> h) & 0xFFFFu),
                  widen<T>((v1[i] >> h) & 0xFFFFu), s1);
        s2 = fmaf(widen<T>((u2[i] >> h) & 0xFFFFu),
                  widen<T>((v2[i] >> h) & 0xFFFFu), s2);
      }
  }
}

// The backward's two score-shaped products over the padded head dim:
// d1 = A1 B1^T and d2 = A2 B2^T, the four tiles K-major in shared memory,
// the tensor cores accumulating straight into d1 and d2.
template <typename T, int DP>
__device__ __forceinline__ void score_products(float (&d1)[32], uint32_t a1,
                                               uint32_t b1, float (&d2)[32],
                                               uint32_t a2, uint32_t b2) {
  pin(d1);
  pin(d2);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    wgmma_ss<T>(d1, kmajor_desc(a1, kk), kmajor_desc(b1, kk), kk);
    wgmma_ss<T>(d2, kmajor_desc(a2, kk), kmajor_desc(b2, kk), kk);
  }
  wg_commit_wait();
  pin(d1);
  pin(d2);
}

// acc += A B over 64 rows, the tensor cores accumulating straight into
// acc: A a 64 x 64 tile rounded into registers (four k16 slices), B a
// 64-row shared tile read MN-major.
template <typename T, int N>
__device__ __forceinline__ void accumulate(float (&acc)[N],
                                           uint32_t (&a)[4][4], uint32_t b) {
  pin(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<T>(acc, a[kk], mnmajor_desc(b, kk), 1);
  wg_commit_wait();
  pin(acc);
  pin(a);
}

// A (query, key) pair, as sequence positions.
struct Pair {
  int query, key;
};

// P = exp(S - lse) and dS = P (dP - Delta) scale of one pair, in place: s
// holds its raw Q K^T dot, dp its dO V^T dot; lse and Delta are the
// query's.  On return s holds P, dp holds dS (both fp32, rounded to the
// input dtype by to_operand).  S * scale and + bias round apart, as the
// plain version's do.  expf, not __expf: P feeds dS, whose rounding an
// approximate exp would move more often.
__device__ __forceinline__ void p_and_ds(const Params& p, float& s,
                                         float& dp, float bias, Pair at,
                                         bool edge, float lse, float delta) {
  float x = __fmul_rn(s, p.scale);
  if (p.bias != nullptr) x = __fadd_rn(x, bias);
  if (edge && (at.key >= p.Sk || at.query >= p.Sq ||
               (p.causal && at.query + p.off < at.key)))
    x = kMask;
  const float pv = expf(x - lse);
  s = pv;
  dp = pv * (dp - delta) * p.scale;
}

// The P or |dS| from which one ulp of T is at least 2^-13: 2^-6 in bf16
// (8 significant bits), 2^-3 in fp16 (11).  A rounding of P or dS to T
// that flips (the tensor cores' sums move S and dP by some fp32 ulps)
// moves a row of dV, dK or dQ by that ulp times an operand: from this
// size on, up to ~4e-3 for unit-normal operands, past the half limit's
// atol of 1e-3 where the row's elements cancel near zero.  Below it, a
// flip moves an output by at most 2^-14 times an operand, under the atol
// for operands under 16.
template <typename T>
__device__ __forceinline__ float flip_limit() {
  return std::is_same<T, __half>::value ? 0.125f : 1.f / 64;
}

// Whether the rounding of an fp32 x to T could go the other way if x
// moved by fewer than kTieUlps fp32 ulps: x lies that close to a midpoint
// between two values of T.  The tensor cores' S and dP and the plain
// chain's differ by ~40-540 ulps of P and dS at unit-normal operands.
constexpr int kTieUlps = 2048;
template <typename T>
__device__ __forceinline__ bool near_tie(float x) {
  constexpr int kDrop = std::is_same<T, __half>::value ? 13 : 16;  // bits
  const int low = static_cast<int>(__float_as_uint(x) & ((1u << kDrop) - 1));
  return abs(low - (1 << (kDrop - 1))) < kTieUlps;
}

// A pair of a 64 x 64 tile: its rows in the query and key tiles, and its
// query's lse and Delta and its key's bias.
struct TilePair {
  int qt, kt;
  float lse, delta, bias;
};

// P and dS of the tile's pairs where P or |dS| is at least flip_limit and
// near a tie of T, again from S and dP summed in the plain version's fp32
// chain (dot_rows2), in place: there P and dS round where the plain
// version's do, so no flip shows (a tie-and-recompute test, as correctly
// rounded math libraries take).  A row whose keys are all masked has
// P = 1 at every key and dS unnormalised, so its dS is often such a pair.
// at(i) names element i of the thread's fragment; q0, k0 and edge are
// the tiles' as p_and_ds takes them.  The loop over the few pairs is not
// unrolled, so the hot path keeps its size: the new values go through
// scratch arrays and come back by predicated moves.
template <typename T, typename At>
__device__ __forceinline__ void plain_pairs(const Params& p, float (&pv)[32],
                                            float (&ds)[32], uint32_t sQ,
                                            uint32_t sK, uint32_t sdO,
                                            uint32_t sV, int q0, int k0,
                                            bool edge, At at) {
  const float limit = flip_limit<T>();
  float top = 0.f;  // most tiles hold no large pair: one max an element
#pragma unroll
  for (int i = 0; i < 32; ++i) top = fmaxf(top, fmaxf(pv[i], fabsf(ds[i])));
  if (top < limit) return;
  uint32_t flag = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if ((pv[i] >= limit && near_tie<T>(pv[i])) ||
        (fabsf(ds[i]) >= limit && near_tie<T>(ds[i])))
      flag |= 1u << i;
  if (flag == 0) return;
  float fp[32], fd[32];
#pragma unroll 1
  for (int i = 0; i < 32; ++i) {
    if (!((flag >> i) & 1u)) continue;
    const TilePair a = at(i);
    float sv, dv;
    dot_rows2<T>(sQ, sK, sdO, sV, a.qt, a.kt, p.D, sv, dv);
    p_and_ds(p, sv, dv, a.bias, Pair{q0 + a.qt, k0 + a.kt}, edge, a.lse,
             a.delta);
    fp[i] = sv;
    fd[i] = dv;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if ((flag >> i) & 1u) {
      pv[i] = fp[i];
      ds[i] = fd[i];
    }
}

// ---- forward: one warpgroup per (b * H + h, 64 queries) -----------------
// Shared memory: Q, then K and V of stage 0 and of stage 1.  The tensor
// cores sum each k/v tile's P V into a fresh accumulator t (4 k16 steps);
// O = O alpha + t in fp32 with round-to-nearest, so the long sum over the
// tiles does not carry the tensor cores' truncation from tile to tile.

template <typename T, int DP>
__global__ void __launch_bounds__(kTcThreads) attn_fwd_kernel_tc(Params p) {
  constexpr int kTileBytes = DP / 64 * kAtomBytes;
  constexpr int kN = DP / 2;  // O's accumulator floats a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  zero_smem(sQ, 5 * kTileBytes);
  __syncthreads();
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // longest first
  const int lane = threadIdx.x & 31, c = lane & 3;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 2);  // rows r, r + 8
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int last = last_kv_tile(p, q0);
  const ChunkWalk w = chunk_walk(p.D);

  load_tile_tc(sQ, q, p.sq, p.vq, b, h, q0, p.Sq, w);
  load_tile_tc(sQ + kTileBytes, k, p.sk, p.vk, b, h, 0, p.Sk, w);
  load_tile_tc(sQ + 2 * kTileBytes, v, p.sv, p.vv, b, h, 0, p.Sk, w);
  cp_async_commit();
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, o[kN], t[kN], s[32];
#pragma unroll
  for (int i = 0; i < kN; ++i) o[i] = t[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  uint32_t a[4][4];
  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kTcKeys;
    const uint32_t sK = sQ + (1 + 2 * (j & 1)) * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    if (j < last) {  // the next k/v tile into the other stage
      const uint32_t nK = sQ + (1 + 2 * ((j + 1) & 1)) * kTileBytes;
      load_tile_tc(nK, k, p.sk, p.vk, b, h, k0 + kTcKeys, p.Sk, w);
      load_tile_tc(nK + kTileBytes, v, p.sv, p.vv, b, h, k0 + kTcKeys, p.Sk,
                   w);
    }
    cp_async_commit();
    wait_tiles();

    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<T>(s, kmajor_desc(sQ, kk), kmajor_desc(sK, kk), kk);
    wg_commit_wait();
    pin(s);

    // S: scale, bias, mask (the diagonal and tail tiles only)
    const bool edge = k0 + kTcKeys > p.Sk || q0 + kTcRows > p.Sq ||
                      (p.causal && k0 + kTcKeys - 1 > q0 + p.off);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * jj + 2 * c + (e & 1);
        float x = s[4 * jj + e] * p.scale;
        if (p.bias != nullptr) x += key_bias(p, b, col);
        if (edge) {
          const int row = q0 + r + 8 * (e >> 1);
          if (col >= p.Sk || row >= p.Sq || (p.causal && row + p.off < col))
            x = kMask;
        }
        s[4 * jj + e] = x;
      }
    // the online softmax over the four threads of each row; exp of a
    // difference (never kMask * log2 e, which overflows)
    float mn[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = s[2 * i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mn[i] = fmaxf(m[i], mx);
      alpha[i] = __expf(m[i] - mn[i]);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = __expf(s[4 * jj + e] - mn[e >> 1]);
        rs[e >> 1] += pv;
        s[4 * jj + e] = pv;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
      m[i] = mn[i];
    }
    to_operand<T>(s, a);

    // t = P V; O = O alpha + t
    pin(t);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T>(t, a[kk], mnmajor_desc(sV, kk), kk);
    wg_commit_wait();
    pin(t);
    pin(a);
    rescale_add(o, t, alpha);
    __syncthreads();  // this stage is read: the next load may refill it
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < kN / 4; ++jj) {
      o[4 * jj + 2 * i] /= lsafe;
      o[4 * jj + 2 * i + 1] /= lsafe;
    }
    const int row = q0 + r + 8 * i;
    if (c == 0 && row < p.Sq)
      p.lse_out[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
          m[i] + logf(lsafe);
  }
  store_acc<T>(static_cast<T*>(p.out), p, b, h, q0, p.Sq, r, c, o);
}

// ---- dQ: one warpgroup per (b * H + h, 64 queries) ----------------------
// The forward's skeleton with the queries stationary.  Shared memory: Q
// and dO, then K and V of stage 0 and of stage 1.  Each thread holds lse
// and Delta of its two rows.  Per k/v tile: S = Q K^T and dP = dO V^T,
// dS on the accumulator fragments, rounded into the A operand of
// dQ += dS K (K read MN-major, as V is in the forward's P V).

// At a padded D of 64 the register budget keeps four blocks an SM (dQ)
// and three (dK/dV), the occupancy of the kernels before plain_pairs.
template <typename T, int DP>
__global__ void __launch_bounds__(kTcThreads, DP == 64 ? 4 : 1)
    attn_dq_kernel_tc(Params p) {
  constexpr int kTileBytes = DP / 64 * kAtomBytes;
  constexpr int kN = DP / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + kTileBytes;
  zero_smem(sQ, 6 * kTileBytes);
  __syncthreads();
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // longest first
  const int lane = threadIdx.x & 31, c = lane & 3;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 2);  // rows r, r + 8
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int last = last_kv_tile(p, q0);
  const ChunkWalk w = chunk_walk(p.D);

  load_tile_tc(sQ, static_cast<const T*>(p.q), p.sq, p.vq, b, h, q0, p.Sq,
               w);
  load_tile_tc(sdO, static_cast<const T*>(p.dout), p.sdo, p.vdo, b, h, q0,
               p.Sq, w);
  load_tile_tc(sQ + 2 * kTileBytes, k, p.sk, p.vk, b, h, 0, p.Sk, w);
  load_tile_tc(sQ + 3 * kTileBytes, v, p.sv, p.vv, b, h, 0, p.Sk, w);
  cp_async_commit();
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r + 8 * i;
    lse[i] = row < p.Sq ? p.lse[row_base + row] : 0.f;
    delta[i] = row < p.Sq ? p.delta[row_base + row] : 0.f;
  }
  float dq[kN], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < kN; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t a[4][4];
  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kTcKeys;
    const uint32_t sK = sQ + (2 + 2 * (j & 1)) * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    if (j < last) {  // the next k/v tile into the other stage
      const uint32_t nK = sQ + (2 + 2 * ((j + 1) & 1)) * kTileBytes;
      load_tile_tc(nK, k, p.sk, p.vk, b, h, k0 + kTcKeys, p.Sk, w);
      load_tile_tc(nK + kTileBytes, v, p.sv, p.vv, b, h, k0 + kTcKeys, p.Sk,
                   w);
    }
    cp_async_commit();
    wait_tiles();

    score_products<T, DP>(s, sQ, sK, dp, sdO, sV);
    const bool edge = k0 + kTcKeys > p.Sk || q0 + kTcRows > p.Sq ||
                      (p.causal && k0 + kTcKeys - 1 > q0 + p.off);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * jj + 2 * c + (e & 1);
        p_and_ds(p, s[4 * jj + e], dp[4 * jj + e], key_bias(p, b, col),
                 Pair{q0 + r + 8 * (e >> 1), col}, edge, lse[e >> 1],
                 delta[e >> 1]);
      }
    plain_pairs<T>(p, s, dp, sQ, sK, sdO, sV, q0, k0, edge, [&](int i) {
      const bool lo = (i & 2) == 0;  // rows r, r + 8 (no dynamic index)
      const int kt = 8 * (i >> 2) + 2 * c + (i & 1);
      return TilePair{r + (lo ? 0 : 8), kt, lo ? lse[0] : lse[1],
                      lo ? delta[0] : delta[1], key_bias(p, b, k0 + kt)};
    });
    to_operand<T>(dp, a);
    accumulate<T>(dq, a, sK);
    __syncthreads();  // this stage is read: the next load may refill it
  }
  store_acc<T>(static_cast<T*>(p.out), p, b, h, q0, p.Sq, r, c, dq);
}

// ---- dK, dV: one warpgroup per (b * H + h, 64 keys) ---------------------
// Shared memory: K, V, then Q and dO of stage 0 and of stage 1, then lse
// and Delta (64 floats each) of stage 0 and of stage 1.  Per q tile:
// S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T on the accumulator
// fragments, rounded into the A operands of dV += P^T dO and
// dK += dS^T Q (dO and Q read MN-major).

template <typename T, int DP>
__global__ void __launch_bounds__(kTcThreads, DP == 64 ? 3 : 1)
    attn_dkdv_kernel_tc(Params p) {
  constexpr int kTileBytes = DP / 64 * kAtomBytes;
  constexpr int kN = DP / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + kTileBytes;
  const uint32_t sRows = sK + 6 * kTileBytes;
  const float* rows = reinterpret_cast<const float*>(
      smem_raw + (sRows - smem_u32(smem_raw)));
  zero_smem(sK, 6 * kTileBytes);
  __syncthreads();
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * kTcKeys;  // longest causal blocks first
  const int lane = threadIdx.x & 31, c = lane & 3;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 2);  // keys k0 + r, + 8
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const int nq = (p.Sq + kTcRows - 1) / kTcRows;
  int first = 0;  // the first q tile that sees this k/v tile
  if (p.causal) {
    const int lo = k0 - p.off - kTcRows + 1;
    first = lo > 0 ? (lo + kTcRows - 1) / kTcRows : 0;
  }
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
  const ChunkWalk w = chunk_walk(p.D);

  load_tile_tc(sK, static_cast<const T*>(p.k), p.sk, p.vk, b, h, k0, p.Sk,
               w);
  load_tile_tc(sV, static_cast<const T*>(p.v), p.sv, p.vv, b, h, k0, p.Sk,
               w);
  load_tile_tc(sK + 2 * kTileBytes, q, p.sq, p.vq, b, h, first * kTcRows,
               p.Sq, w);
  load_tile_tc(sK + 3 * kTileBytes, dout, p.sdo, p.vdo, b, h,
               first * kTcRows, p.Sq, w);
  load_rows_tc(sRows, p, row_base, first * kTcRows);
  cp_async_commit();
  const float bias[2] = {key_bias(p, b, k0 + r), key_bias(p, b, k0 + r + 8)};
  float dk[kN], dv[kN], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < kN; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  uint32_t pa[4][4], da[4][4];
  for (int it = first; it < nq; ++it) {
    const int q0 = it * kTcRows, stage = (it - first) & 1;
    const uint32_t sQ = sK + (2 + 2 * stage) * kTileBytes;
    const uint32_t sdO = sQ + kTileBytes;
    const float* lse = rows + 128 * stage;
    const float* delta = lse + 64;
    if (it + 1 < nq) {  // the next q tile into the other stage
      const uint32_t nQ = sK + (2 + 2 * (stage ^ 1)) * kTileBytes;
      load_tile_tc(nQ, q, p.sq, p.vq, b, h, q0 + kTcRows, p.Sq, w);
      load_tile_tc(nQ + kTileBytes, dout, p.sdo, p.vdo, b, h, q0 + kTcRows,
                   p.Sq, w);
      load_rows_tc(sRows + 512 * (stage ^ 1), p, row_base, q0 + kTcRows);
    }
    cp_async_commit();
    wait_tiles();

    score_products<T, DP>(st, sK, sQ, dpt, sV, sdO);
    const bool edge = q0 + kTcRows > p.Sq || k0 + kTcKeys > p.Sk ||
                      (p.causal && q0 + p.off < k0 + kTcKeys - 1);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * jj + 2 * c + (e & 1);
        p_and_ds(p, st[4 * jj + e], dpt[4 * jj + e], bias[e >> 1],
                 Pair{q0 + qi, k0 + r + 8 * (e >> 1)}, edge, lse[qi],
                 delta[qi]);
      }
    plain_pairs<T>(p, st, dpt, sQ, sK, sdO, sV, q0, k0, edge, [&](int i) {
      const bool lo = (i & 2) == 0;  // keys r, r + 8 (no dynamic index)
      const int qt = 8 * (i >> 2) + 2 * c + (i & 1);
      return TilePair{qt, r + (lo ? 0 : 8), lse[qt], delta[qt],
                      lo ? bias[0] : bias[1]};
    });
    to_operand<T>(st, pa);
    to_operand<T>(dpt, da);
    accumulate<T>(dv, pa, sdO);
    accumulate<T>(dk, da, sQ);
    __syncthreads();  // this stage is read: the next load may refill it
  }
  store_acc<T>(static_cast<T*>(p.dk), p, b, h, k0, p.Sk, r, c, dk);
  store_acc<T>(static_cast<T*>(p.dv), p, b, h, k0, p.Sk, r, c, dv);
}

// ---- fp32 on the CUDA cores ----------------------------------------------
// SIMT-GEMM register tiles (the note at the head of the file).  A block of
// kF32Threads is two groups of 128 threads (warps 0-3 and 4-7) over the
// same kRows stationary rows: keys in dK/dV, queries in dQ and the
// forward.  In a group, thread (rg, cg) owns the rows row(i) = (i / 4)
// kRows / 2 + 4 rg + i % 4 (i < 8), the streamed rows col(j) = cg + kCG j
// of a tile (j < kTC) and the head-dim columns dcol(e) = (e / 4) DP / 2 +
// 4 cg + e % 4 (e < 8), so that every shared-memory read is a 16-byte load
// that a warp takes without a bank conflict (row strides kLd and kLdP are
// 4 past a multiple of 32 floats).

constexpr int kF32Threads = 256;
constexpr int kF32Group = 128;
// Stationary rows a block and streamed rows a tile, at a head dim padded to
// 64 and to 128 (tests/test_torch_attention.py reads these four).
constexpr int kF32Rows64 = 128;
constexpr int kF32Cols64 = 64;
constexpr int kF32Rows128 = 64;
constexpr int kF32Cols128 = 48;

template <int DP>
struct F32Tiles {
  static constexpr int kRows = DP == 64 ? kF32Rows64 : kF32Rows128;
  static constexpr int kCols = DP == 64 ? kF32Cols64 : kF32Cols128;
  static constexpr int kRG = kRows / 8;        // row groups of 8 rows
  static constexpr int kCG = kF32Group / kRG;  // column groups: DP / 8
  static constexpr int kTC = kCols / kCG;      // streamed rows a thread
  static constexpr int kLd = DP + 4;           // a streamed tile's row stride
  static constexpr int kLdP = kRows + 4;       // P and dS, [col][row]
  // A ring stage: two streamed tiles and two floats a streamed row (dK/dV:
  // lse and Delta; dQ: the key bias).
  static constexpr int kStage = 2 * kCols * kLd + 2 * kCols;
  // Floats of shared memory: two transposed stationary tiles, two stages,
  // P and dS, two floats a stationary row (dK/dV: the key bias; dQ: lse
  // and Delta).
  static constexpr int kSmem =
      2 * DP * kRows + 2 * kStage + 2 * kCols * kLdP + 2 * kRows;
  // The forward's: Q^T, two stages, P twice, each row's alpha twice and l.
  static constexpr int kFwdSmem =
      DP * kRows + 2 * kStage + 2 * kCols * kLdP + 3 * kRows;
  static_assert(kCG * 8 == DP, "a thread accumulates 8 head-dim columns");
  static_assert(kTC * kCG == kCols, "a tile splits evenly over a group");
  static_assert(kCols * 4 <= kF32Threads, "four threads load a row");
  static_assert(kCG <= 32 && 32 % kCG == 0, "a row group lies in one warp");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// The 128 threads of group g alone (barrier 1 + g; __syncthreads is 0).
__device__ __forceinline__ void group_sync(int g) {
  if (g == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// The transposed tile dst[d][r] (R rows, d < D) of rows row0 .. row0 +
// R - 1 of head (b, h); rows at or past n_rows are zero.  Once a block:
// the stationary tiles.  Consecutive threads take consecutive rows, so
// the stores meet no bank conflict: when the rows are contiguous and
// 16-byte aligned (`vec`), a thread loads 16 bytes of its row and stores
// them as four columns (ready at the next barrier); otherwise it starts
// 4-byte cp.async copies through the strides.
template <int R>
__device__ __forceinline__ void f32_load_t(float* dst, const float* src,
                                           const long long* st, int vec,
                                           int b, int h, int row0,
                                           int n_rows, int D) {
  const int r = threadIdx.x % R;
  const int row = row0 + r;
  const bool in = row < n_rows;
  const float* s =
      src + b * st[0] + h * st[2] + (in ? row : n_rows - 1) * st[1];
  if (vec) {  // 16-byte loads, four stores
#pragma unroll 4
    for (int d = 4 * (threadIdx.x / R); d < D; d += 4 * (kF32Threads / R)) {
      const float4 x = in ? __ldg(reinterpret_cast<const float4*>(s + d))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[d * R + r] = x.x;
      dst[(d + 1) * R + r] = x.y;
      dst[(d + 2) * R + r] = x.z;
      dst[(d + 3) * R + r] = x.w;
    }
  } else {
    const uint32_t base = smem_u32(dst);
    for (int d = threadIdx.x / R; d < D; d += kF32Threads / R)
      cp_async4(base + 4 * (d * R + r), s + d * st[3], in ? 4 : 0);
  }
}

// Start copying rows row0 .. row0 + kCols - 1 of head (b, h) into the
// row-major tile dst[r][d] (row stride kLd), four threads a row: 16-byte
// chunks when the rows are contiguous and 16-byte aligned (`vec`), else
// 4-byte copies through the strides into the same layout.  Rows at or past
// n_rows are zero.
template <int DP>
__device__ __forceinline__ void f32_load_rows(uint32_t dst, const float* src,
                                              const long long* st, int vec,
                                              int b, int h, int row0,
                                              int n_rows, int D) {
  using T = F32Tiles<DP>;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  if (r >= T::kCols) return;
  const int row = row0 + r;
  const bool in = row < n_rows;
  const float* s =
      src + b * st[0] + h * st[2] + (in ? row : n_rows - 1) * st[1];
  const uint32_t d_row = dst + 4 * r * T::kLd;
  if (vec) {
    for (int d = 4 * part; d < D; d += 16)
      cp_async16(d_row + 4 * d, s + d, in ? 16 : 0);
  } else {
    for (int d = part; d < D; d += 4)
      cp_async4(d_row + 4 * d, s + d * st[3], in ? 4 : 0);
  }
}

// Start copying dst[i] = src[(row0 + i) * stride] for i < n (zero at or
// past n_rows), one float a thread from thread t0 on.
__device__ __forceinline__ void f32_load_vec(uint32_t dst, const float* src,
                                             long long stride, int row0,
                                             int n_rows, int n, int t0) {
  const int i = static_cast<int>(threadIdx.x) - t0;
  if (i < 0 || i >= n) return;
  const int row = row0 + i;
  cp_async4(dst + 4 * i, src + (row < n_rows ? row : n_rows - 1) * stride,
            row < n_rows ? 4 : 0);
}

// s[i][j] = sum over d < D of At[d][row(i)] * Bt[col(j)][d], one fused
// multiply-add per d in order: At a transposed stationary tile
// ([DP][kRows]), Bt a row-major streamed one ([kCols][kLd]).  Per four d a
// thread reads kTC + 8 float4 for 32 kTC multiply-adds: 4 a float read at
// kTC = 8.  Four steps unrolled: the next step's loads issue early (the
// whole loop unrolled at D = 64 was slower: PERF.md).
template <int DP>
__device__ __forceinline__ void f32_scores(
    const float* At, const float* Bt, int D, int rg, int cg,
    float (&s)[8][F32Tiles<DP>::kTC]) {
  using T = F32Tiles<DP>;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < T::kTC; ++j) s[i][j] = 0.f;
  const float* a_at = At + 4 * rg;
  const float* b_at = Bt + cg * T::kLd;
  auto step = [&](int d0) {  // d0 .. d0 + 3
    float4 bv[T::kTC];
#pragma unroll
    for (int j = 0; j < T::kTC; ++j)
      bv[j] = ld4(b_at + j * T::kCG * T::kLd + d0);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float* ad = a_at + (d0 + dd) * T::kRows;
      const float4 a0 = ld4(ad), a1 = ld4(ad + T::kRows / 2);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int j = 0; j < T::kTC; ++j) {
        const float bj = comp(bv[j], dd);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][j] = fmaf(a[i], bj, s[i][j]);
      }
    }
  };
#pragma unroll 4
  for (int d0 = 0; d0 < D; d0 += 4) step(d0);
}

// acc[i][e] += sum over c < kCols of Pt[c][row(i)] * M[c][dcol(e)], one
// fused multiply-add per c in order: Pt is P or dS stored [col][row] (row
// stride kLdP), M a row-major streamed tile.  The thread's R rows are
// row0 + (i / 4) kRows / 2 + i % 4.  Per c a thread reads R / 4 + 2 float4
// for 8 R multiply-adds: 4 a float read at R = 8, 2.67 at R = 4.
template <int DP, int R>
__device__ __forceinline__ void f32_accumulate(const float* Pt,
                                               const float* M, int row0,
                                               int cg, float (&acc)[R][8]) {
  using T = F32Tiles<DP>;
  const float* p_at = Pt + row0;
  const float* m_at = M + 4 * cg;
#pragma unroll 8
  for (int c = 0; c < T::kCols; ++c) {
    float pv[R];
#pragma unroll
    for (int h = 0; h < R / 4; ++h) {
      const float4 x = ld4(p_at + c * T::kLdP + h * (T::kRows / 2));
      pv[4 * h] = x.x, pv[4 * h + 1] = x.y, pv[4 * h + 2] = x.z,
      pv[4 * h + 3] = x.w;
    }
    const float4 m0 = ld4(m_at + c * T::kLd);
    const float4 m1 = ld4(m_at + c * T::kLd + DP / 2);
    const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(pv[i], mv[e], acc[i][e]);
  }
}

// Column j of the thread's score tile into Pt[col][row(i)].
template <int DP>
__device__ __forceinline__ void f32_put(float* Pt, int rg, int col,
                                        const float (&s)[8][F32Tiles<DP>::kTC],
                                        int j) {
  using T = F32Tiles<DP>;
  float* at = Pt + col * T::kLdP + 4 * rg;
  st4(at, s[0][j], s[1][j], s[2][j], s[3][j]);
  st4(at + T::kRows / 2, s[4][j], s[5][j], s[6][j], s[7][j]);
}

// The scaled, biased, masked score of (query, key) from its raw Q K^T dot,
// rounded as the plain version rounds: dot * scale, then + bias (no fused
// multiply-add); the mask (checked on edge tiles only) replaces it.
__device__ __forceinline__ float f32_score(const Params& p, float dot,
                                           float bias, bool edge, int query,
                                           int key) {
  float x = __fmul_rn(dot, p.scale);
  if (p.bias != nullptr) x = __fadd_rn(x, bias);
  if (edge && (key >= p.Sk || query >= p.Sq ||
               (p.causal && query + p.off < key)))
    x = kMask;
  return x;
}

// P = exp(x - lse) and dS = P (dP - Delta) scale of one pair, in place: x
// holds its score, dp its dO V^T dot; on return x holds P and dp dS.
__device__ __forceinline__ void f32_p_ds(const Params& p, float& x, float& dp,
                                         float lse, float delta) {
  x = expf(x - lse);
  dp = x * (dp - delta) * p.scale;
}

// Rows row0 + (i / 4) kRows / 2 + i % 4 (i < R) below n_rows of a
// contiguous (B, n_rows, H, D) output, the head-dim columns below D.
template <int DP, int R>
__device__ __forceinline__ void f32_store(float* dst, const Params& p, int b,
                                          int h, int row0, int n_rows,
                                          int cg, const float (&acc)[R][8]) {
  using T = F32Tiles<DP>;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + (i >> 2) * (T::kRows / 2) + (i & 3);
    if (row >= n_rows) continue;
    float* out =
        dst + ((static_cast<long long>(b) * n_rows + row) * p.H + h) * p.D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d0 = half * (DP / 2) + 4 * cg;
      if (d0 < p.D)
        st4(out + d0, acc[i][4 * half], acc[i][4 * half + 1],
            acc[i][4 * half + 2], acc[i][4 * half + 3]);
    }
  }
}

// The max (kMax) or the sum of v over the kCG threads of a row group,
// which are kCG neighbouring lanes of one warp.
template <int kCG, bool kMax>
__device__ __forceinline__ float row_reduce(float v) {
#pragma unroll
  for (int o = 1; o < kCG; o <<= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  return v;
}

// Barrier 0 for all kF32Threads threads, reached from the two groups' own
// loops (each warp arrives; where in the code does not matter).
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0, 256;\n" ::: "memory");
}

// ---- forward: one block per (b * H + h, kRows queries) ------------------
// Shared memory: Q^T ([d][query]), two ring stages of K and V (row-major)
// with the keys' bias, P stored [key][query] twice, each row's rescale
// alpha twice, and each row's l.  Step t: group 0 sums S = Q K^T of k/v
// tile t, scales, biases and masks it (edge tiles), and runs the online
// softmax: the row max over its kTC columns and the row group's lanes,
// alpha = exp(m_old - m_new), P = exp(S - m_new), l = l alpha + the row
// sum; it writes P and alpha to buffer t & 1.  Meanwhile group 1 scales
// its O tile by tile t - 1's alpha and adds P V of tile t - 1.  So the
// block runs last + 2 steps with one barrier each.  Each group has its own
// loop, so that O's 64 registers are live in group 1's code alone and S's
// in group 0's; a row's m and l live in one lane of its row group (lane
// cg holds row cg's), shuffled to the others once a tile.  The ring is
// staggered: step t starts K and the bias of tile t + 1 and V of tile t,
// each into the stage of its tile's parity, which the step before
// finished reading.  Each element of O is one in-order fused multiply-add
// chain over the keys, rescaled between tiles.

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1) attn_fwd_kernel(Params p) {
  using T = F32Tiles<DP>;
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);
  float* sStage = sQt + DP * T::kRows;
  float* sP = sStage + 2 * T::kStage;
  float* sAlpha = sP + 2 * T::kCols * T::kLdP;
  float* sL = sAlpha + 2 * T::kRows;
  for (int i = threadIdx.x; i < T::kFwdSmem / 4; i += kF32Threads)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kRows;  // longest first
  const int group = threadIdx.x / kF32Group, t = threadIdx.x % kF32Group;
  const int rg = t / T::kCG, cg = t % T::kCG;
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const int nk = (p.Sk + T::kCols - 1) / T::kCols;
  // the last k/v tile that the block's last query sees
  const int last =
      p.causal
          ? min(nk - 1, (min(q0 + T::kRows, p.Sq) - 1 + p.off) / T::kCols)
          : nk - 1;
  // Start of step it, in both groups: tile it's K and it - 1's V are in,
  // step it - 1 is done; start K of tile it + 1 and V of tile it.
  auto step = [&](int it) {
    cp_async_wait_all();
    block_sync();
    if (it < last) {
      float* st = sStage + ((it + 1) & 1) * T::kStage;
      const int k0 = (it + 1) * T::kCols;
      f32_load_rows<DP>(smem_u32(st), k, p.sk, p.vk, b, h, k0, p.Sk, p.D);
      if (p.bias != nullptr)
        f32_load_vec(smem_u32(st + 2 * T::kCols * T::kLd),
                     p.bias + b * p.sbias[0], p.sbias[1], k0, p.Sk, T::kCols,
                     0);
    }
    if (it <= last)
      f32_load_rows<DP>(
          smem_u32(sStage + (it & 1) * T::kStage + T::kCols * T::kLd), v,
          p.sv, p.vv, b, h, it * T::kCols, p.Sk, p.D);
    cp_async_commit();
  };

  // tile 0's K and bias first: they fly while Q^T loads
  f32_load_rows<DP>(smem_u32(sStage), k, p.sk, p.vk, b, h, 0, p.Sk, p.D);
  if (p.bias != nullptr)
    f32_load_vec(smem_u32(sStage + 2 * T::kCols * T::kLd),
                 p.bias + b * p.sbias[0], p.sbias[1], 0, p.Sk, T::kCols, 0);
  f32_load_t<T::kRows>(sQt, static_cast<const float*>(p.q), p.sq, p.vq, b, h,
                       q0, p.Sq, p.D);
  cp_async_commit();

  if (group == 0) {  // S and the online softmax
    const int lane0 = (threadIdx.x & 31) & ~(T::kCG - 1);
    float m_own = kMask, l_own = 0.f;  // row cg's (cg < 8)
    for (int it = 0; it <= last + 1; ++it) {
      step(it);
      if (it > last) continue;
      const int k0 = it * T::kCols;
      const float* sK = sStage + (it & 1) * T::kStage;
      const float* sBias = sK + 2 * T::kCols * T::kLd;
      float s[8][T::kTC];
      f32_scores<DP>(sQt, sK, p.D, rg, cg, s);
      const bool edge = k0 + T::kCols > p.Sk || q0 + T::kRows > p.Sq ||
                        (p.causal && k0 + T::kCols - 1 > q0 + p.off);
#pragma unroll
      for (int j = 0; j < T::kTC; ++j) {
        const int col = cg + T::kCG * j;
        const float bias = sBias[col];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          s[i][j] = f32_score(p, s[i][j], bias, edge,
                              q0 + (i >> 2) * (T::kRows / 2) + 4 * rg + (i & 3),
                              k0 + col);
      }
      float* alpha = sAlpha + (it & 1) * T::kRows;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float m_old = __shfl_sync(0xffffffffu, m_own, lane0 + i);
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < T::kTC; ++j) mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m_old, row_reduce<T::kCG, true>(mx));
        // exp of a difference (never kMask * log2 e, which overflows)
        const float a = expf(m_old - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < T::kTC; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
        rs = row_reduce<T::kCG, false>(rs);
        if (cg == i) {
          l_own = l_own * a + rs;
          m_own = m_new;
          alpha[(i >> 2) * (T::kRows / 2) + 4 * rg + (i & 3)] = a;
        }
      }
#pragma unroll
      for (int j = 0; j < T::kTC; ++j)
        f32_put<DP>(sP + (it & 1) * T::kCols * T::kLdP, rg, cg + T::kCG * j,
                    s, j);
      if (it == last && cg < 8) {  // row cg's l for group 1, and its lse
        const int row = (cg >> 2) * (T::kRows / 2) + 4 * rg + (cg & 3);
        const float lsafe = l_own == 0.f ? 1.f : l_own;
        sL[row] = lsafe;
        if (q0 + row < p.Sq)
          p.lse_out[(static_cast<long long>(b) * p.H + h) * p.Sq + q0 + row] =
              m_own + logf(lsafe);
      }
    }
  } else {  // O = O alpha + P V
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
    for (int it = 0; it <= last + 1; ++it) {
      step(it);
      if (it == 0) continue;
      const int j = it - 1;
      const float* al = sAlpha + (j & 1) * T::kRows + 4 * rg;
      const float4 a0 = ld4(al), a1 = ld4(al + T::kRows / 2);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] *= a[i];
      f32_accumulate<DP, 8>(sP + (j & 1) * T::kCols * T::kLdP,
                            sStage + (j & 1) * T::kStage + T::kCols * T::kLd,
                            4 * rg, cg, acc);
    }
    // O = acc / l; group 0 wrote l at step last, before step last + 1
    const float4 l0 = ld4(sL + 4 * rg), l1 = ld4(sL + T::kRows / 2 + 4 * rg);
    const float ls[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] /= ls[i];
    f32_store<DP, 8>(static_cast<float*>(p.out), p, b, h, q0 + 4 * rg, p.Sq,
                     cg, acc);
  }
}

// ---- dK, dV: one block per (b * H + h, kRows keys) ----------------------
// Shared memory: K^T and V^T ([d][key]), two ring stages of Q and dO
// (row-major) with lse and Delta, P^T and dS^T stored [query][key], the
// keys' bias.  Per q tile: group 0 sums S^T = K Q^T and writes the scores,
// group 1 sums dP^T = V dO^T and writes it; after a barrier every thread
// turns a quarter of its score tile's pairs (group g the rows of chunk g)
// into P^T and dS^T in place; after another, group 0 sums dV += P^T dO and
// group 1 dK += dS^T Q, each row of them one chain over the queries in
// order.

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1) attn_dkdv_kernel(Params p) {
  using T = F32Tiles<DP>;
  extern __shared__ float4 smem4[];
  float* sKt = reinterpret_cast<float*>(smem4);
  float* sVt = sKt + DP * T::kRows;
  float* sStage = sVt + DP * T::kRows;
  float* sP = sStage + 2 * T::kStage;
  float* sdS = sP + T::kCols * T::kLdP;
  float* sBias = sdS + T::kCols * T::kLdP;
  for (int i = threadIdx.x; i < T::kSmem / 4; i += kF32Threads)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * T::kRows;  // the longest causal blocks first
  const int group = threadIdx.x / kF32Group, t = threadIdx.x % kF32Group;
  const int rg = t / T::kCG, cg = t % T::kCG;
  const float* q = static_cast<const float*>(p.q);
  const float* dout = static_cast<const float*>(p.dout);
  const int nq = (p.Sq + T::kCols - 1) / T::kCols;
  // the first q tile that sees the block's first key
  const int first = p.causal && k0 > p.off ? (k0 - p.off) / T::kCols : 0;
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
  auto load_stage = [&](int it) {
    float* st = sStage + ((it - first) & 1) * T::kStage;
    const int q0 = it * T::kCols;
    f32_load_rows<DP>(smem_u32(st), q, p.sq, p.vq, b, h, q0, p.Sq, p.D);
    f32_load_rows<DP>(smem_u32(st + T::kCols * T::kLd), dout, p.sdo, p.vdo,
                      b, h, q0, p.Sq, p.D);
    const uint32_t rows = smem_u32(st + 2 * T::kCols * T::kLd);
    f32_load_vec(rows, p.lse + row_base, 1, q0, p.Sq, T::kCols, 0);
    f32_load_vec(rows + 4 * T::kCols, p.delta + row_base, 1, q0, p.Sq,
                 T::kCols, kF32Group);
  };

  // the first tile's copies first: they fly while the stationary tiles load
  load_stage(first);
  if (p.bias != nullptr)
    f32_load_vec(smem_u32(sBias), p.bias + b * p.sbias[0], p.sbias[1], k0,
                 p.Sk, T::kRows, 0);
  f32_load_t<T::kRows>(sKt, static_cast<const float*>(p.k), p.sk, p.vk, b,
                       h, k0, p.Sk, p.D);
  f32_load_t<T::kRows>(sVt, static_cast<const float*>(p.v), p.sv, p.vv, b,
                       h, k0, p.Sk, p.D);
  cp_async_commit();
  float acc[8][8], s[8][T::kTC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int it = first; it < nq; ++it) {
    const int q0 = it * T::kCols;
    const float* sQ = sStage + ((it - first) & 1) * T::kStage;
    const float* sdO = sQ + T::kCols * T::kLd;
    const float* sLse = sdO + T::kCols * T::kLd;
    const float* sDelta = sLse + T::kCols;
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every read of tile it - 1 is done
    if (it + 1 < nq) load_stage(it + 1);
    cp_async_commit();

    // S^T (group 0) or dP^T (group 1) into sP or sdS
    f32_scores<DP>(group ? sVt : sKt, group ? sdO : sQ, p.D, rg, cg, s);
    if (group == 0) {
      const bool edge = q0 + T::kCols > p.Sq || k0 + T::kRows > p.Sk ||
                        (p.causal && q0 + p.off < k0 + T::kRows - 1);
      float bias[8];
      const float4 b0 = ld4(sBias + 4 * rg);
      const float4 b1 = ld4(sBias + T::kRows / 2 + 4 * rg);
      bias[0] = b0.x, bias[1] = b0.y, bias[2] = b0.z, bias[3] = b0.w;
      bias[4] = b1.x, bias[5] = b1.y, bias[6] = b1.z, bias[7] = b1.w;
#pragma unroll
      for (int j = 0; j < T::kTC; ++j) {
        const int col = cg + T::kCG * j;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          s[i][j] = f32_score(p, s[i][j], bias[i], edge, q0 + col,
                              k0 + (i >> 2) * (T::kRows / 2) + 4 * rg +
                                  (i & 3));
      }
    }
#pragma unroll
    for (int j = 0; j < T::kTC; ++j)
      f32_put<DP>(group ? sdS : sP, rg, cg + T::kCG * j, s, j);
    __syncthreads();  // the scores and dP^T are in
#pragma unroll
    for (int j = 0; j < T::kTC; ++j) {  // P^T and dS^T, rows of chunk group
      const int col = cg + T::kCG * j;
      const int at = col * T::kLdP + group * (T::kRows / 2) + 4 * rg;
      float4 x = ld4(sP + at), dp = ld4(sdS + at);
      const float lse = sLse[col], delta = sDelta[col];
      f32_p_ds(p, x.x, dp.x, lse, delta);
      f32_p_ds(p, x.y, dp.y, lse, delta);
      f32_p_ds(p, x.z, dp.z, lse, delta);
      f32_p_ds(p, x.w, dp.w, lse, delta);
      st4(sP + at, x.x, x.y, x.z, x.w);
      st4(sdS + at, dp.x, dp.y, dp.z, dp.w);
    }
    __syncthreads();  // P^T and dS^T are in
    if (group == 0)
      f32_accumulate<DP, 8>(sP, sdO, 4 * rg, cg, acc);  // dV += P^T dO
    else
      f32_accumulate<DP, 8>(sdS, sQ, 4 * rg, cg, acc);  // dK += dS^T Q
  }
  f32_store<DP, 8>(static_cast<float*>(group ? p.dk : p.dv), p, b, h,
                   k0 + 4 * rg, p.Sk, cg, acc);
}

// ---- dQ: one block per (b * H + h, kRows queries) -----------------------
// Shared memory: Q^T and dO^T ([d][query]), two ring stages of K and V
// (row-major) with the keys' bias, the Q K^T dots and dP (then dS) stored
// [key][query], the queries' lse and Delta.  Per k/v tile: group 0 sums
// Q K^T, group 1 dP = dO V^T, and each writes its tile; after a barrier
// group g turns the pairs of its half of the queries into scores, P and
// dS = P (dP - Delta) scale and, after its own barrier, sums dQ += dS K
// for those queries, each element one chain over the keys in order.

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1) attn_dq_kernel(Params p) {
  using T = F32Tiles<DP>;
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);
  float* sdOt = sQt + DP * T::kRows;
  float* sStage = sdOt + DP * T::kRows;
  float* sX = sStage + 2 * T::kStage;
  float* sdS = sX + T::kCols * T::kLdP;
  float* sLse = sdS + T::kCols * T::kLdP;
  float* sDelta = sLse + T::kRows;
  for (int i = threadIdx.x; i < T::kSmem / 4; i += kF32Threads)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kRows;  // longest first
  const int group = threadIdx.x / kF32Group, t = threadIdx.x % kF32Group;
  const int rg = t / T::kCG, cg = t % T::kCG;
  const int row0 = group * (T::kRows / 2) + 4 * rg;  // the dQ rows' first
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const int nk = (p.Sk + T::kCols - 1) / T::kCols;
  // the last k/v tile that the block's last query sees
  const int last =
      p.causal
          ? min(nk - 1, (min(q0 + T::kRows, p.Sq) - 1 + p.off) / T::kCols)
          : nk - 1;
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
  auto load_stage = [&](int j) {
    float* st = sStage + (j & 1) * T::kStage;
    const int k0 = j * T::kCols;
    f32_load_rows<DP>(smem_u32(st), k, p.sk, p.vk, b, h, k0, p.Sk, p.D);
    f32_load_rows<DP>(smem_u32(st + T::kCols * T::kLd), v, p.sv, p.vv, b, h,
                      k0, p.Sk, p.D);
    if (p.bias != nullptr)
      f32_load_vec(smem_u32(st + 2 * T::kCols * T::kLd),
                   p.bias + b * p.sbias[0], p.sbias[1], k0, p.Sk, T::kCols,
                   0);
  };

  // the first tile's copies first: they fly while the stationary tiles load
  load_stage(0);
  f32_load_vec(smem_u32(sLse), p.lse + row_base, 1, q0, p.Sq, T::kRows, 0);
  f32_load_vec(smem_u32(sDelta), p.delta + row_base, 1, q0, p.Sq, T::kRows,
               kF32Group);
  f32_load_t<T::kRows>(sQt, static_cast<const float*>(p.q), p.sq, p.vq, b, h,
                       q0, p.Sq, p.D);
  f32_load_t<T::kRows>(sdOt, static_cast<const float*>(p.dout), p.sdo, p.vdo,
                       b, h, q0, p.Sq, p.D);
  cp_async_commit();
  float acc[4][8], s[8][T::kTC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int j = 0; j <= last; ++j) {
    const int k0 = j * T::kCols;
    const float* sK = sStage + (j & 1) * T::kStage;
    const float* sV = sK + T::kCols * T::kLd;
    const float* sBias = sV + T::kCols * T::kLd;
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every read of tile j - 1 is done
    if (j < last) load_stage(j + 1);
    cp_async_commit();

    // the Q K^T dots (group 0) or dP (group 1) into sX or sdS
    f32_scores<DP>(group ? sdOt : sQt, group ? sV : sK, p.D, rg, cg, s);
#pragma unroll
    for (int jj = 0; jj < T::kTC; ++jj)
      f32_put<DP>(group ? sdS : sX, rg, cg + T::kCG * jj, s, jj);
    __syncthreads();  // the dots and dP are in
    // dS of the group's queries; the scores' scale, bias and mask here too:
    // faster than in group 0 before the barrier, while dK/dV is faster the
    // other way (tools/attn_variants.py dq_scores_g0, dkdv_scores_shared)
    const bool edge = k0 + T::kCols > p.Sk || q0 + T::kRows > p.Sq ||
                      (p.causal && k0 + T::kCols - 1 > q0 + p.off);
    const float4 lse = ld4(sLse + row0), delta = ld4(sDelta + row0);
#pragma unroll
    for (int jj = 0; jj < T::kTC; ++jj) {
      const int col = cg + T::kCG * jj;
      const int at = col * T::kLdP + row0;
      float4 x = ld4(sX + at), dp = ld4(sdS + at);
      const float bias = sBias[col];
      x.x = f32_score(p, x.x, bias, edge, q0 + row0, k0 + col);
      x.y = f32_score(p, x.y, bias, edge, q0 + row0 + 1, k0 + col);
      x.z = f32_score(p, x.z, bias, edge, q0 + row0 + 2, k0 + col);
      x.w = f32_score(p, x.w, bias, edge, q0 + row0 + 3, k0 + col);
      f32_p_ds(p, x.x, dp.x, lse.x, delta.x);
      f32_p_ds(p, x.y, dp.y, lse.y, delta.y);
      f32_p_ds(p, x.z, dp.z, lse.z, delta.z);
      f32_p_ds(p, x.w, dp.w, lse.w, delta.w);
      st4(sdS + at, dp.x, dp.y, dp.z, dp.w);
    }
    group_sync(group);  // the group's dS is in
    f32_accumulate<DP, 4>(sdS, sK, row0, cg, acc);  // dQ += dS K
  }
  f32_store<DP, 4>(static_cast<float*>(p.out), p, b, h, q0 + row0, p.Sq, cg,
                   acc);
}

// kind 0 forward, 1 dQ, 2 dK/dV; the head dim padded to 64 or 128.
template <int DP>
int launch_f32(int kind, const Params& p, cudaStream_t stream) {
  using T = F32Tiles<DP>;
  const size_t bytes = (kind == 0 ? T::kFwdSmem : T::kSmem) * sizeof(float);
  const int rows = kind == 2 ? p.Sk : p.Sq;
  const dim3 grid(p.B * p.H, (rows + T::kRows - 1) / T::kRows);
  void (*kernel)(Params) = kind == 0   ? attn_fwd_kernel<DP>
                           : kind == 1 ? attn_dq_kernel<DP>
                                       : attn_dkdv_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kF32Threads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// kind 0 forward, 1 dQ, 2 dK/dV.
template <typename T, int DP>
int launch_tc(int kind, const Params& p, cudaStream_t stream) {
  constexpr size_t tile = DP / 64 * kAtomBytes;
  // + 1024: the tiles start at the next 1024-byte boundary
  const size_t bytes = kind == 0   ? 5 * tile + 1024
                       : kind == 1 ? 6 * tile + 1024
                                   : 6 * tile + 4 * kTcRows * sizeof(float) +
                                         1024;
  const int rows = kind == 2 ? p.Sk : p.Sq;
  const dim3 grid(p.B * p.H, (rows + kTcRows - 1) / kTcRows);
  void (*kernel)(Params) = kind == 0   ? attn_fwd_kernel_tc<T, DP>
                           : kind == 1 ? attn_dq_kernel_tc<T, DP>
                                       : attn_dkdv_kernel_tc<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kTcThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The route is the dtype's: fp32 takes the CUDA-core kernels, bf16 and
// fp16 the tensor cores' (the head dim padded to 64 or 128).
template <typename T>
int launch(int kind, const Params& p, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return p.D <= 64 ? launch_tc<T, 64>(kind, p, stream)
                     : launch_tc<T, 128>(kind, p, stream);
  } else {
    return p.D <= 64 ? launch_f32<64>(kind, p, stream)
                     : launch_f32<128>(kind, p, stream);
  }
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
  // cp.async's 16-byte chunks: a contiguous row at a 16-byte aligned start
  auto vec = [](const void* ptr, const long long* st) {
    return static_cast<int>(ptr != nullptr && st[3] == 1 && st[0] % 8 == 0 &&
                            st[1] % 8 == 0 && st[2] % 8 == 0 &&
                            reinterpret_cast<uintptr_t>(ptr) % 16 == 0);
  };
  p.vq = vec(q, p.sq);
  p.vk = vec(k, p.sk);
  p.vv = vec(v, p.sv);
  p.vdo = vec(dout, p.sdo);
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
