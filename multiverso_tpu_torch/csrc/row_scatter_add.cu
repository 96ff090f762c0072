// Row scatter-add for Hopper (sm_90a):
//   table[ids[i], :] += to_table_dtype(coef_i * deltas[i, :]),
//   coef_i = row_scale[wrapped ids[i]] * alpha with a per-row scale table,
//   alpha without one (1 leaves the deltas as they are).
//
// Replaces the Pallas read-modify-write kernel of the word2vec kernel probe,
//   tools/w2v_kernel_probe.py::_rmw_kernel (via pallas_rmw), a serial loop
//     of per-row DMAs of the enclosing 8-row tile (serial because zipf
//     duplicates make a pipelined RMW race),
// and in the port serves every row update of the word2vec step (the JAX
// package's w.at[rows].add(((-lr) * scale[:, None] * grads).astype(w.dtype))
// at models/word2vec.py:473-486, the scaling folded in) and of
// MatrixTable.add_rows.
//
// Contract (.at[].add's default mode): the table is updated in place.
// Duplicate ids accumulate, each add rounded on its own, as XLA's scatter
// does: no two deltas are combined before they reach the table (that would
// be JAX's update_impl="segsum", another result on zipf head rows). A
// negative id wraps (-1 -> row V-1); an id out of range after the wrap is
// dropped, and its row scale is never read. The products are f32
// __fmul_rn in the order the JAX step takes them, (scale * alpha) first,
// then times the delta; the result is rounded to the table dtype (round to
// nearest even) and added. The table is f32 or bf16, the deltas f32, or
// bf16 into a bf16 table, at any D. The order in which
// duplicates land is not fixed, as it is not for the XLA scatter on an
// accelerator.
//
// What bounds it on this card: bytes. Each update row is read once (its
// id, scale and deltas) and each distinct table row is read and written
// once in L2; one multiply an element. What the design does about it:
// - the adds are Hopper's 16-byte vector reductions, fire-and-forget in
//   L2: red.global.add.noftz.v4.bf16x2 (8 bf16) into a bf16 table,
//   red.global.add.v4.f32 (4 f32) into an f32 one. A 200-wide bf16 row
//   takes 25 of them instead of 100 pairwise atomics, so the chains on a
//   zipf head row, where reductions to one address serialise in L2, are
//   4x shorter and no row needs a lock or a sort;
// - the deltas, read once, arrive by 16-byte streaming loads
//   (ld.global.cs, first out of L2), leaving L2 to the table rows;
// - the block's threads walk the flattened [N, table words] space, so no
//   lane idles on a row of 25 words, and each lane has kUnroll = 4 update
//   rows' loads in flight before its first reduction;
// - the f32 scaling is done here, so the caller builds no scaled copy of
//   the deltas, and one launch does the whole update: no host sync, no
//   allocation, so a CUDA graph can capture it.
// Rows that cannot take 16-byte words go one element (f32) or one pair
// (bf16) a lane, with the scalar atomics: a bf16 table with D not a
// multiple of 8, an f32 one with D not a multiple of 4, or a table or
// deltas not 16-byte aligned. A bf16 table whose D is odd (a [size]
// vector: 2-byte rows), or whose pairs are not 4-byte aligned, goes one
// element a lane with the 2-byte bf16 atomic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kMaxBlocks = 132LL * 16;

// entry dtype bits
constexpr int kTableBf16 = 1;
constexpr int kDeltasBf16 = 2;

__device__ __forceinline__ float bf16_bits(uint32_t lo16) {
  return __uint_as_float(lo16 << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// E consecutive deltas at p (aligned to their own width) as f32, read
// once: streaming loads.
__device__ __forceinline__ void load(const float* p, float (&v)[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load(const float* p, float (&v)[2]) {
  const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = __ldcs(p);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
  v[0] = bf16_bits(a.x); v[1] = bf16_hi(a.x);
  v[2] = bf16_bits(a.y); v[3] = bf16_hi(a.y);
  v[4] = bf16_bits(a.z); v[5] = bf16_hi(a.z);
  v[6] = bf16_bits(a.w); v[7] = bf16_hi(a.w);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[2]) {
  const uint32_t a = __ldcs(reinterpret_cast<const unsigned int*>(p));
  v[0] = bf16_bits(a); v[1] = bf16_hi(a);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = bf16_bits(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // RNE each
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Add E rounded values at p: one 16-byte vector reduction, or the scalar
// atomics of the narrow route.
__device__ __forceinline__ void reduce(__nv_bfloat16* p, const float (&v)[8]) {
  asm volatile(
      "red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};" ::"l"(
          __cvta_generic_to_global(p)),
      "r"(pack_bf16x2(v[0], v[1])), "r"(pack_bf16x2(v[2], v[3])),
      "r"(pack_bf16x2(v[4], v[5])), "r"(pack_bf16x2(v[6], v[7]))
      : "memory");
}
__device__ __forceinline__ void reduce(float* p, const float (&v)[4]) {
  asm volatile(
      "red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(
          __cvta_generic_to_global(p)),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
      : "memory");
}
__device__ __forceinline__ void reduce(__nv_bfloat16* p, const float (&v)[2]) {
  atomicAdd(reinterpret_cast<__nv_bfloat162*>(p),
            __floats2bfloat162_rn(v[0], v[1]));
}
__device__ __forceinline__ void reduce(__nv_bfloat16* p, const float (&v)[1]) {
  atomicAdd(p, __float2bfloat16_rn(v[0]));
}
__device__ __forceinline__ void reduce(float* p, const float (&v)[1]) {
  atomicAdd(p, v[0]);
}

// T: table element, Dt: delta element, E: elements a lane adds at once
// (16 bytes of the table, or the narrow routes' 1 or 2). Index as in
// row_gather.cu: 32-bit below 2^31 units.
template <typename T, typename Dt, int E, typename Index>
__global__ void __launch_bounds__(kThreads)
scatter_rows(T* __restrict__ table, const int32_t* __restrict__ ids,
             const Dt* __restrict__ deltas,
             const float* __restrict__ row_scale, float alpha, Index units,
             Index row_units, long long rows) {
  const Index step = (Index)gridDim.x * (kThreads * kUnroll);
  for (Index base = (Index)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
       base < units; base += step) {
    float v[kUnroll][E];
    long long dst[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Index k = base + (Index)(u * kThreads);
      dst[u] = -1;
      if (k < units) {
        const Index r = k / row_units;
        long long id = __ldg(ids + r);
        if (id < 0) id += rows;
        if (id >= 0 && id < rows) {
          const long long col = (long long)(k - r * row_units) * E;
          const float coef =
              row_scale ? __fmul_rn(__ldg(row_scale + id), alpha) : alpha;
          load(deltas + (long long)r * row_units * E + col, v[u]);
#pragma unroll
          for (int e = 0; e < E; ++e) v[u][e] = __fmul_rn(coef, v[u][e]);
          dst[u] = id * (long long)row_units * E + col;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (dst[u] >= 0) reduce(table + dst[u], v[u]);
  }
}

template <typename T, typename Dt, int E>
int launch(void* table, const void* ids, const void* deltas,
           const float* row_scale, float alpha, long long n, long long rows,
           long long row_units, cudaStream_t st) {
  const long long units = n * row_units;
  long long blocks = (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  T* tab = static_cast<T*>(table);
  const int32_t* idx = static_cast<const int32_t*>(ids);
  const Dt* d = static_cast<const Dt*>(deltas);
  if (units < (1LL << 31))
    scatter_rows<T, Dt, E, uint32_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        tab, idx, d, row_scale, alpha, (uint32_t)units, (uint32_t)row_units,
        rows);
  else
    scatter_rows<T, Dt, E, unsigned long long>
        <<<(unsigned)blocks, kThreads, 0, st>>>(
            tab, idx, d, row_scale, alpha, (unsigned long long)units,
            (unsigned long long)row_units, rows);
  return (int)cudaGetLastError();
}

// The 16-byte route when D and the pointers allow it, else the bf16 pair
// route, else one element a lane.
template <typename T, typename Dt>
int dispatch(void* table, const void* ids, const void* deltas,
             const float* row_scale, float alpha, long long n,
             long long rows, int D, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kNarrow = sizeof(T) == 2 ? 2 : 1;
  const bool vec = D % kVec == 0
                   && reinterpret_cast<uintptr_t>(table) % 16 == 0
                   && reinterpret_cast<uintptr_t>(deltas) % 16 == 0;
  if (vec)
    return launch<T, Dt, kVec>(table, ids, deltas, row_scale, alpha, n, rows,
                               D / kVec, st);
  if (D % kNarrow == 0
      && reinterpret_cast<uintptr_t>(table) % (kNarrow * sizeof(T)) == 0
      && reinterpret_cast<uintptr_t>(deltas) % (kNarrow * sizeof(Dt)) == 0)
    return launch<T, Dt, kNarrow>(table, ids, deltas, row_scale, alpha, n,
                                  rows, D / kNarrow, st);
  return launch<T, Dt, 1>(table, ids, deltas, row_scale, alpha, n, rows, D,
                          st);
}

}  // namespace

// dtypes: kTableBf16 | kDeltasBf16 bits (clear: f32); bf16 deltas need a
// bf16 table. row_scale: a [rows]
// f32 table, or null. `device` is the tensors' device ordinal. Returns a
// CUDA error code (0 when n == 0: nothing is launched).
extern "C" int mv_row_scatter_add(void* table, const void* ids,
                                  const void* deltas, const void* row_scale,
                                  float alpha, long long n, long long rows,
                                  int D, int dtypes, int device,
                                  void* stream) {
  if (n < 0 || rows <= 0 || D <= 0 || (dtypes & ~(kTableBf16 | kDeltasBf16))
      || dtypes == kDeltasBf16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  DeviceScope scope(device);
  if (scope.error()) return scope.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* scale = static_cast<const float*>(row_scale);
  switch (dtypes) {
    case 0:
      return dispatch<float, float>(table, ids, deltas, scale, alpha, n,
                                    rows, D, st);
    case kTableBf16:
      return dispatch<__nv_bfloat16, float>(table, ids, deltas, scale, alpha,
                                            n, rows, D, st);
    default:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(table, ids, deltas, scale,
                                                    alpha, n, rows, D, st);
  }
}
