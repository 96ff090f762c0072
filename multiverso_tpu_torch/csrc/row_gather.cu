// Row gather for Hopper (sm_90a): out[i, :] = table[ids[i], :], in the
// table's dtype or, from a bf16 table, widened to f32.
//
// Replaces the Pallas row-gather kernels of the word2vec kernel probe,
//   tools/w2v_kernel_probe.py::_gather_kernel (via pallas_gather), a
//     per-row DMA of the enclosing 8-row tile through a DEPTH-8 ring,
//   tools/w2v_kernel_probe.py::subtile_rejected's inner kern, the 8 one-row
//     DMAs that Mosaic refuses to compile,
// and in the port serves every embedding-row gather of the word2vec step
// (the JAX package's jnp.take at models/word2vec.py:525,549,689, whose
// bf16 rows XLA widens to f32 inside the product that reads them) and of
// MatrixTable.get_rows.
//
// Contract (jnp.take's default mode): a [V, D] table in f32 or bf16, int32
// ids, a contiguous [N, D] out in the table dtype, or in f32 from a bf16
// table (widened exactly: the bf16 bits are the top half of the f32). A
// negative id wraps (-1 -> row V-1); an id >= V or < -V gives a row of NaN
// (0x7fc00000 in f32, 0x7fc0 in bf16). The kernel never reads outside the
// table.
//
// What bounds it on this card: bytes. It does no arithmetic; the least it
// can move is each distinct row read once plus the output written once.
// What the design does about it:
// - the block's threads walk the flattened [N, row words] space of 16-byte
//   row words, so a warp covers 32 consecutive words of one to three rows
//   and no lane idles (a 200-wide bf16 row is 25 words, which left 7 of 32
//   lanes idle in a warp-per-row design);
// - each lane issues kUnroll = 4 independent 16-byte loads, at rows
//   kThreads words apart, before its first store, to hide the latency of
//   the random row reads (hot zipf rows come from L2);
// - the f32 route widens in registers and writes two 16-byte words per
//   word read, so the caller needs no cast pass over the result;
// - stores are cache-streaming (st.global.cs): timed against plain stores
//   with the consumer that reads the rows, they measured no slower
//   (PERF.md).
// Rows whose byte width is not a multiple of 16, or tables or outputs not
// 16-byte aligned, take the one-element-a-lane route (a bf16 table with D
// not a multiple of 8, an f32 one with D not a multiple of 4).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kMaxBlocks = 132LL * 16;

// entry mode bits
constexpr int kBf16 = 1;    // the table is bf16 (else f32)
constexpr int kWiden = 2;   // write f32 (needs a bf16 table)

// Out: what one unit read becomes in `out`. Widened, 16 bytes of bf16
// become 32 bytes of f32, and one bf16 one f32.
struct Wide {
  uint4 lo, hi;
};

template <typename T>
__device__ __forceinline__ T widen_unit(T v, T*) {
  return v;
}
// bf16 bits b are the f32 bits b << 16; elements stay in memory order
__device__ __forceinline__ Wide widen_unit(uint4 v, Wide*) {
  return {make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16,
                     v.y & 0xffff0000u),
          make_uint4(v.z << 16, v.z & 0xffff0000u, v.w << 16,
                     v.w & 0xffff0000u)};
}
__device__ __forceinline__ uint32_t widen_unit(uint16_t v, uint32_t*) {
  return (uint32_t)v << 16;
}

template <typename T>
__device__ __forceinline__ void put(T* p, T v) {
  __stcs(p, v);
}
__device__ __forceinline__ void put(Wide* p, Wide v) {
  __stcs(&p->lo, v.lo);
  __stcs(&p->hi, v.hi);
}

// In: the unit a lane reads; Out: what it writes (In, or Wide / uint32_t
// when widening). Index: unsigned 32-bit when the unit count is below
// 2^31 (so base + step cannot wrap), for a cheap division by the row's
// unit count; 64-bit otherwise.
template <typename In, typename Out, typename Index>
__global__ void __launch_bounds__(kThreads)
gather_rows(const In* __restrict__ table, const int32_t* __restrict__ ids,
            Out* __restrict__ out, Index units, Index row_units,
            long long rows, Out fill) {
  const Index step = (Index)gridDim.x * (kThreads * kUnroll);
  for (Index base = (Index)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
       base < units; base += step) {
    Out v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Index k = base + (Index)(u * kThreads);
      if (k < units) {
        const Index r = k / row_units;
        long long id = __ldg(ids + r);
        if (id < 0) id += rows;
        v[u] = fill;
        if (id >= 0 && id < rows)
          v[u] = widen_unit(
              __ldg(table + id * (long long)row_units
                    + (long long)(k - r * row_units)),
              (Out*)nullptr);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Index k = base + (Index)(u * kThreads);
      if (k < units) put(out + k, v[u]);
    }
  }
}

template <typename In, typename Out>
int launch(const void* table, const void* ids, void* out, long long n,
           long long rows, long long row_units, Out fill, cudaStream_t st) {
  const long long units = n * row_units;
  long long blocks = (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const In* tab = static_cast<const In*>(table);
  const int32_t* idx = static_cast<const int32_t*>(ids);
  Out* dst = static_cast<Out*>(out);
  if (units < (1LL << 31))
    gather_rows<In, Out, uint32_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        tab, idx, dst, (uint32_t)units, (uint32_t)row_units, rows, fill);
  else
    gather_rows<In, Out, unsigned long long>
        <<<(unsigned)blocks, kThreads, 0, st>>>(
            tab, idx, dst, (unsigned long long)units,
            (unsigned long long)row_units, rows, fill);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: kBf16 | kWiden bits (above). The row is row_bytes of the
// table's dtype; a widened out row is twice that. `device` is the tensors'
// device ordinal. Returns a CUDA error code (0 when n == 0: nothing is
// launched).
extern "C" int mv_row_gather(const void* table, const void* ids, void* out,
                             long long n, long long rows, int row_bytes,
                             int mode, int device, void* stream) {
  const bool bf16 = mode & kBf16, widen = mode & kWiden;
  const int elem = bf16 ? 2 : 4;
  if (n < 0 || rows <= 0 || row_bytes <= 0 || row_bytes % elem
      || (widen && !bf16) || (mode & ~(kBf16 | kWiden)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  DeviceScope scope(device);
  if (scope.error()) return scope.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t nan32 = bf16 && !widen ? 0x7fc07fc0u : 0x7fc00000u;
  const uint4 nan4 = make_uint4(nan32, nan32, nan32, nan32);
  const bool vec = row_bytes % 16 == 0
                   && reinterpret_cast<uintptr_t>(table) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec && widen)
    return launch<uint4, Wide>(table, ids, out, n, rows, row_bytes / 16,
                               Wide{nan4, nan4}, st);
  if (vec)
    return launch<uint4, uint4>(table, ids, out, n, rows, row_bytes / 16,
                                nan4, st);
  if (widen)
    return launch<uint16_t, uint32_t>(table, ids, out, n, rows,
                                      row_bytes / 2, nan32, st);
  if (!bf16)
    return launch<uint32_t, uint32_t>(table, ids, out, n, rows,
                                      row_bytes / 4, nan32, st);
  return launch<uint16_t, uint16_t>(table, ids, out, n, rows, row_bytes / 2,
                                    (uint16_t)0x7fc0, st);
}
