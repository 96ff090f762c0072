// Row scatter-add for Hopper (sm_90a): table[ids[i], :] += deltas[i, :].
//
// Replaces the Pallas read-modify-write kernel of the word2vec kernel probe,
//   tools/w2v_kernel_probe.py::_rmw_kernel (via pallas_rmw), a serial loop
//     of per-row DMAs of the enclosing 8-row tile (serial because zipf
//     duplicates make a pipelined RMW race),
// and in the port serves every row scatter-add of the word2vec step (the
// JAX package's w.at[rows].add(upd.astype(w.dtype)) at
// models/word2vec.py:486) and of MatrixTable.add_rows.
//
// Contract (.at[].add's default mode): the table is updated in place.
// Duplicate ids accumulate. A negative id wraps (-1 -> row V-1); an id out
// of range after the wrap is dropped. Each delta is first rounded to the
// table dtype (round to nearest even) and then added, which is what the
// JAX step computes with upd.astype(w.dtype) followed by the scatter; so an
// f32 delta buffer needs no cast pass before a bf16 table. Supported
// (table, delta) dtypes: (f32, f32), (bf16, f32), (bf16, bf16); a bf16
// table needs an even D (adds go two elements at a time). The order in
// which duplicates land is not fixed, as it is not for the XLA scatter.
//
// What bounds it on this card: bytes. Each update row is read once (its
// delta and id) and each distinct table row is read and written once; the
// arithmetic is one add per element. What the design does about it: one
// warp per update row, lanes on consecutive elements (float, or bf16
// pairs), each add a fire-and-forget atomic in L2 (red.global.add), so
// rows need no locks and duplicates need no sort. The cost it accepts:
// atomics on one address serialise in L2, so a zipf head row hit thousands
// of times per step is a chain of that length. A sort + segmented-reduce
// design that removes the chain is a later performance change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 64;

__device__ __forceinline__ void add_pair(__nv_bfloat162* dst, float2 v) {
  atomicAdd(dst, __floats2bfloat162_rn(v.x, v.y));
}
__device__ __forceinline__ void add_pair(__nv_bfloat162* dst,
                                         __nv_bfloat162 v) {
  atomicAdd(dst, v);
}

// f32 table, f32 deltas: one float atomic per element.
__global__ void __launch_bounds__(kThreads)
scatter_add_f32(float* __restrict__ table, const int32_t* __restrict__ ids,
                const float* __restrict__ deltas, long long n, long long rows,
                int D) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long stride = ((long long)gridDim.x * kThreads) >> 5;
  for (long long i = first; i < n; i += stride) {
    long long id = ids[i];
    if (id < 0) id += rows;
    if (id < 0 || id >= rows) continue;
    float* dst = table + id * D;
    const float* src = deltas + i * D;
    for (int c = lane; c < D; c += 32) atomicAdd(dst + c, src[c]);
  }
}

// bf16 table; P is the delta pair type (float2 or __nv_bfloat162).
template <typename P>
__global__ void __launch_bounds__(kThreads)
scatter_add_bf16(__nv_bfloat16* __restrict__ table,
                 const int32_t* __restrict__ ids, const P* __restrict__ deltas,
                 long long n, long long rows, int D) {
  const int lane = threadIdx.x & 31;
  const int pairs = D / 2;
  const long long first = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long stride = ((long long)gridDim.x * kThreads) >> 5;
  for (long long i = first; i < n; i += stride) {
    long long id = ids[i];
    if (id < 0) id += rows;
    if (id < 0 || id >= rows) continue;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(table + id * D);
    const P* src = deltas + i * pairs;
    for (int c = lane; c < pairs; c += 32) add_pair(dst + c, src[c]);
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// table_dtype / delta_dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() of the launch (0 when n == 0: nothing is launched).
extern "C" int mv_row_scatter_add(void* table, const void* ids,
                                  const void* deltas, long long n,
                                  long long rows, int D, int table_dtype,
                                  int delta_dtype, void* stream) {
  if (n < 0 || rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n);
  const int32_t* idx = static_cast<const int32_t*>(ids);
  if (table_dtype == 0 && delta_dtype == 0) {
    scatter_add_f32<<<grid, kThreads, 0, st>>>(
        static_cast<float*>(table), idx, static_cast<const float*>(deltas),
        n, rows, D);
    return (int)cudaGetLastError();
  }
  if (table_dtype != 1 || D % 2) return (int)cudaErrorInvalidValue;
  __nv_bfloat16* tab = static_cast<__nv_bfloat16*>(table);
  if (delta_dtype == 0) {
    scatter_add_bf16<float2><<<grid, kThreads, 0, st>>>(
        tab, idx, static_cast<const float2*>(deltas), n, rows, D);
    return (int)cudaGetLastError();
  }
  if (delta_dtype == 1) {
    scatter_add_bf16<__nv_bfloat162><<<grid, kThreads, 0, st>>>(
        tab, idx, static_cast<const __nv_bfloat162*>(deltas), n, rows, D);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
