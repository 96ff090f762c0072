// Row gather for Hopper (sm_90a): out[i, :] = table[ids[i], :].
//
// Replaces the Pallas row-gather kernels of the word2vec kernel probe,
//   tools/w2v_kernel_probe.py::_gather_kernel (via pallas_gather), a
//     per-row DMA of the enclosing 8-row tile through a DEPTH-8 ring,
//   tools/w2v_kernel_probe.py::subtile_rejected's inner kern, the 8 one-row
//     DMAs that Mosaic refuses to compile,
// and in the port serves every embedding-row gather of the word2vec step
// (the JAX package's jnp.take at models/word2vec.py:525,549,689).
//
// Contract (jnp.take's default mode): a [V, D] table in f32 or bf16, int32
// ids, a contiguous [N, D] out in the table dtype. A negative id wraps
// (-1 -> row V-1); an id >= V or < -V gives a row of NaN (0x7fc00000 in
// f32, 0x7fc0 in bf16). The kernel never reads outside the table.
//
// What bounds it on this card: bytes. It does no arithmetic; the least it
// can move is each distinct row read once plus the output written once.
// What the design does about it: one warp per output row, its lanes on
// consecutive 16-byte words (a 200-wide bf16 row is 25 of them), so every
// row read and write is one coalesced transaction per 512 bytes; many rows
// are in flight per SM (8 warps a block, grid-stride over the rows) to hide
// the latency of the random row reads. Hot rows (zipf heads) are served
// from L2. There is no tile granularity to work around: unlike the TPU's
// 8-row HBM tile, a Hopper load reads exactly the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 64;

// W: the unit each lane moves (uint4 = 16 bytes, or one element).
template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_rows(const W* __restrict__ table, const int32_t* __restrict__ ids,
            W* __restrict__ out, long long n, long long rows, int row_words,
            W fill) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long stride = ((long long)gridDim.x * kThreads) >> 5;
  for (long long i = first; i < n; i += stride) {
    long long id = ids[i];
    if (id < 0) id += rows;
    W* dst = out + i * row_words;
    if (id >= 0 && id < rows) {
      const W* src = table + id * row_words;
      for (int c = lane; c < row_words; c += 32) dst[c] = src[c];
    } else {
      for (int c = lane; c < row_words; c += 32) dst[c] = fill;
    }
  }
}

template <typename W>
int launch(const void* table, const void* ids, void* out, long long n,
           long long rows, int row_words, W fill, cudaStream_t stream) {
  long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(table), static_cast<const int32_t*>(ids),
      static_cast<W*>(out), n, rows, row_words, fill);
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 = float32, 2 = bfloat16 (it picks the NaN fill). The row is
// D = row_bytes / elem_bytes elements. Returns cudaGetLastError() of the
// launch (0 when n == 0: nothing is launched).
extern "C" int mv_row_gather(const void* table, const void* ids, void* out,
                             long long n, long long rows, int row_bytes,
                             int elem_bytes, void* stream) {
  if (n < 0 || rows <= 0 || row_bytes <= 0
      || (elem_bytes != 2 && elem_bytes != 4) || row_bytes % elem_bytes)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t nan32 = elem_bytes == 4 ? 0x7fc00000u : 0x7fc07fc0u;
  const bool vec = row_bytes % 16 == 0
                   && reinterpret_cast<uintptr_t>(table) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    return launch<uint4>(table, ids, out, n, rows, row_bytes / 16,
                         make_uint4(nan32, nan32, nan32, nan32), st);
  if (elem_bytes == 4)
    return launch<uint32_t>(table, ids, out, n, rows, row_bytes / 4, nan32,
                            st);
  return launch<uint16_t>(table, ids, out, n, rows, row_bytes / 2,
                          (uint16_t)0x7fc0, st);
}
