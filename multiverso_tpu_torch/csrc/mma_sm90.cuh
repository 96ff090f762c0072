// Building blocks of the bf16 tensor-core flash kernels (sm_90a), shared by
// flash_fwd.cu and flash_bwd.cu: 16-byte cp.async copies into XOR-swizzled
// shared-memory tiles, ldmatrix operand loads, the mma.sync.m16n8k16 bf16
// product with f32 accumulators, and the repacking of an f32 accumulator
// fragment into the A operand of the next product.
//
// Every kernel that uses them runs kThreads threads (4 warps) over tiles
// of kBlock rows: a warp owns 16 rows of a tile, and the thread with lane
// index 4 g + t holds rows g and g + 8 of an accumulator fragment, columns
// 2 t and 2 t + 1 of each 8-column block.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;     // rows (q rows or keys) per tile
constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// one past the last key that a row of [q0, q0 + kBlock) sees: with the
// causal mask, keys at global positions k_base + k up to the tile's last
// row q_base + q; keys past it are masked for every row of the tile, so
// their tiles are skipped
__device__ __forceinline__ int key_end(int Sq, int Sk, int q_base,
                                       int k_base, int causal, int q0) {
  if (!causal) return Sk;
  const int q_last = min(q0 + kBlock, Sq) - 1;
  const long long lim = (long long)q_base + q_last - k_base + 1;
  return (int)max(0LL, min((long long)Sk, lim));
}

// the same, from a kernel's argument struct
template <class A>
__device__ __forceinline__ int key_end(const A& a, int q0) {
  return key_end(a.Sq, a.Sk, a.q_base, a.k_base, a.causal, q0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a tile of C chunks a row. The
// chunk index is XORed with r % 8, so the 8 rows that one ldmatrix matrix
// reads fall in 8 different bank groups.
template <int C>
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (uint32_t)((r * C + (c ^ (r & 7))) * 16);
}

// Per-thread byte offsets, in a swizzled tile of C chunks a row, of the
// rows that ldmatrix reads for each operand shape. Every row a lane
// addresses is lane % 8 modulo 8, so chunk pair j of a row is the lane's
// offset XOR (j << 5), and 16 rows further on is + 256 C: the addresses of
// a whole unrolled loop are one register and immediates.
template <int C>
struct Lanes {
  uint32_t a;    // A, row-major: rows lane % 16, chunk lane / 16
  uint32_t b;    // B held transposed (row n, k contiguous): rows lane % 8
                 // + 8 (lane / 16), chunk (lane / 8) % 2
  uint32_t bt;   // B held as it is (row k, n contiguous), ldmatrix.trans:
                 // rows lane % 8 + 8 ((lane / 8) % 2), chunk lane / 16
  __device__ __forceinline__ explicit Lanes(int lane) {
    const int r7 = lane & 7, hi = lane >> 4, mid = (lane >> 3) & 1;
    a = ((lane & 15) * C + (hi ^ r7)) * 16;
    b = ((r7 + 8 * hi) * C + (mid ^ r7)) * 16;
    bt = ((r7 + 8 * mid) * C + (hi ^ r7)) * 16;
  }
};

// A operand: the 16 x 16 block at rows m0 (a multiple of 16), chunk pair j
template <int C>
__device__ __forceinline__ void ld_a(uint32_t (&r)[4], uint32_t tile,
                                     const Lanes<C>& l, int m0, int j) {
  ldsm(r, tile + m0 * C * 16 + (l.a ^ (j << 5)));
}

// B operands of two n8 blocks, rows n0 and n0 + 8 of a tile that holds B
// transposed, chunk pair j (k): r[0..1] for n0, r[2..3] for n0 + 8
template <int C>
__device__ __forceinline__ void ld_b(uint32_t (&r)[4], uint32_t tile,
                                     const Lanes<C>& l, int n0, int j) {
  ldsm(r, tile + n0 * C * 16 + (l.b ^ (j << 5)));
}

// B operands of two n8 blocks, chunk pair j (n), rows k0..k0+15 of a tile
// that holds B as it is: r[0..1] for the first n8 block, r[2..3] the next
template <int C>
__device__ __forceinline__ void ld_bt(uint32_t (&r)[4], uint32_t tile,
                                      const Lanes<C>& l, int k0, int j) {
  ldsm_t(r, tile + k0 * C * 16 + (l.bt ^ (j << 5)));
}

// rows [row0, row0 + kBlock) of one head of a [B, S, H, D] bf16 tensor into
// a swizzled [kBlock][DM] tile; rows at or past n and columns at or past D
// are zero-filled
template <int DM>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride,
                                                int row0, int n, int D) {
  constexpr int C = DM / 8;
#pragma unroll
  for (int j = 0; j < kBlock * C / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / C, c = i % C;
    const bool in = row0 + r < n && c * 8 < D;
    const __nv_bfloat16* p =
        in ? src + (long long)(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + sw<C>(r, c), p, in ? 16 : 0);
  }
}

// A fragments of the next product from an f32 accumulator tile (16 x 8 NB)
template <int NB>
__device__ __forceinline__ void to_a(uint32_t (&a)[NB / 2][4],
                                     const float (&c)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// the 16-byte copies' alignment: pointer and (batch, seq, head) strides
inline bool async_copy_ok(const void* p, const long long* strides) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && strides[0] % 8 == 0
      && strides[1] % 8 == 0 && strides[2] % 8 == 0;
}

}  // namespace
