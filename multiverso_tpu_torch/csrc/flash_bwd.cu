// Flash-attention backward for Hopper (sm_90a): the CUDA counterpart of the
// JAX package's three Pallas backward kernels,
//   multiverso_tpu/ops/flash_attention.py::_bwd_fused_kernel (:469, one pass, nk==1)
//   multiverso_tpu/ops/flash_attention.py::_bwd_dq_kernel    (:350, dq pass)
//   multiverso_tpu/ops/flash_attention.py::_bwd_dkv_kernel   (:409, dk/dv pass)
// Two kernels cover the three on each route: the kv kernel is the dk/dv
// pass and, with kDQ, the one-pass kernel that also produces dq; the dq
// kernel is the dq pass.
//
// Contract (identical to the Pallas kernels'):
//   q, g [B, Sq, H, D] and k, v [B, Sk, H, D], read through the given
//   strides (the last dim must be contiguous), f32 or bf16, one dtype;
//   lse, delta [B, H, Sq] f32: the q rows' logsumexp m + log l and
//   rowsum(g * out) from the forward;
//   dq [B, Sq, H, D], dk / dv [B, Sk, H, D] contiguous f32.
//   p = exp(s * scale - lse) on live (row, key) pairs and 0 elsewhere,
//   chosen by a select and never by a product: a row that the causal mask
//   leaves with no live key has lse ~ -1e30, so exp(s - lse) is inf there
//   and inf * 0 would be NaN. Causal masking is in global positions: key j
//   of row i is live when k_base + j <= q_base + i. Ragged edges and
//   Sq != Sk are masked here: nothing is padded in device memory.
//   dv += p^T g with p rounded to g's dtype (_bwd_dkv_kernel:451-453);
//   ds = p * (g v^T - delta) * scale, rounded to k's dtype before ds k
//   (dq) and to q's dtype before ds^T q (dk), as the Pallas kernels do.
//
// What bounds it on this card: the backward does four (dq, dk/dv passes)
// or five (one pass) products of 2 * D flops per live (row, key) pair and
// reads each input once, so at the training path's shapes (S 1024-2048,
// head_dim 64) the tensor cores' bf16 rate (989 TFLOP/s) is the bound, not
// memory. No [Sq, Sk] matrix reaches device memory (p and ds are
// recomputed per tile from lse and delta), and tiles wholly above the
// causal diagonal are never visited, which halves causal work.
//
// Two routes, chosen by the dtype (never by a failure):
//
// bf16: tensor-core kernels (mma_bwd_dq_kernel, mma_bwd_kv_kernel). Every
//   product is an mma.sync.m16n8k16 with bf16 operands and f32
//   accumulators; operands come from swizzled bf16 shared-memory tiles
//   through ldmatrix (row XOR chunk swizzle: no bank conflicts), and the
//   next tile is loaded with 16-byte cp.async (zero-filled past the rows
//   and past D) while this one computes. The f32 accumulator fragment of
//   s (or s^T) has the layout of the next product's A operand, so p and ds
//   are formed, selected, rounded to bf16 and fed back from registers:
//     mma_bwd_dq_kernel: one 4-warp block per (batch * head, 64-row q
//       tile), each warp owning 16 q rows; Q and G stay in shared memory,
//       K and V tiles are double-buffered; s = q k^T and dp = g v^T, then
//       dq += ds k with k from ldmatrix.trans; dq is written once.
//     mma_bwd_kv_kernel: one 4-warp block per (batch * head, 64-key tile),
//       each warp owning 16 keys; K and V stay in shared memory, the q / g
//       tiles and their lse / delta are double-buffered; s^T = k q^T and
//       dp^T = v g^T, then dv += p^T g and dk += ds^T q with g and q from
//       ldmatrix.trans, accumulated in registers and written once. At D 128
//       the 64-column q tile is taken in two halves to bound registers.
//       (4 warps of 16 rows: ptxas gives the D 64 kernels 223-251
//       registers, two blocks an SM, without spills.)
//       With kDQ (the one pass) ds^T also goes to shared memory as bf16,
//       dq_tile = ds k is an mma with ds from ldmatrix.trans, and the f32
//       partial is added into the zeroed dq with float2 atomicAdd (eight
//       full 32-byte sectors a warp instruction). Partial dq buffers per
//       key tile would take nk times dq's size (16 x 25 MB at the
//       flagship's seq 1024) and a second pass. The cost: the order of the
//       (at most Sk / 64) adds into one dq element changes from run to
//       run, so dq is not bitwise reproducible; it differs from an ordered
//       sum by a few f32 ulps of the sum of |contributions|.
//   Head dims: the kernels are built for a D bucket of 64 or 128; a D that
//   is a multiple of 8 below its bucket is zero-filled up to it in shared
//   memory. The grid puts the longest blocks first under the causal mask:
//   blockIdx.y walks key tiles from the first (which meets every q tile)
//   and q tiles from the last (which meets every key tile). The 16-byte
//   copies need each operand 16-byte aligned with batch, seq and head
//   strides that are multiples of 8 elements (the wrapper checks; the
//   entry point refuses others with cudaErrorMisalignedAddress).
//
// f32: CUDA-core kernels (bwd_dq_kernel, bwd_kv_kernel), fmaf products
//   with f32 tiles in shared memory. On the tensor cores f32 would be
//   TF32, which cannot hold f32 accuracy; their redesign is later work.
//   Same blocks and loops as above: thread pairs own a tile row, and the
//   one pass adds dq with coalesced f32 atomicAdd from a staged tile.

#include "mma_sm90.cuh"

namespace {

constexpr int kPP = kBlock + 1;  // padded row of the f32 route's p / ds tiles
constexpr int kKindFused = 0, kKindDq = 1, kKindDkv = 2;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int H, Sq, Sk, D;
  long long qs[3], ks[3], vs[3], gs[3];  // (batch, seq, head) strides
  int causal;
  float scale;
  int q_base, k_base;
};

// first q row (a multiple of kBlock) that sees key k0 under the mask
__device__ __forceinline__ int first_q_tile(const Args& a, int k0) {
  if (!a.causal) return 0;
  const long long first = (long long)a.k_base + k0 - a.q_base;
  const int q = first <= 0 ? 0 : (int)min((long long)a.Sq, first);
  return q - q % kBlock;
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (building blocks in mma_sm90.cuh)
// ---------------------------------------------------------------------------

// 4 bytes global -> shared (the kv kernel's lse / delta); src_bytes 0
// writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// dq tile: s (rows q, cols keys) -> ds in place. lse2 = lse * log2(e).
template <bool kMask>
__device__ __forceinline__ void dq_grad_tile(float (&s)[8][4],
                                             const float (&dp)[8][4],
                                             const Args& a, int r0, int k0,
                                             int t, const float (&lse2)[2],
                                             const float (&dl)[2]) {
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      bool live = true;
      if (kMask) {
        const int row = r0 + 8 * i, key = k0 + nb * 8 + 2 * t + (e & 1);
        live = key < a.Sk && row < a.Sq
            && (!a.causal || (long long)a.k_base + key
                              <= (long long)a.q_base + row);
      }
      const float p = live ? exp2f(fmaf(s[nb][e], sl2, -lse2[i])) : 0.f;
      s[nb][e] = live ? p * (dp[nb][e] - dl[i]) * a.scale : 0.f;
    }
}

template <int DM>
__global__ void __launch_bounds__(kThreads) mma_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int C = DM / 8;
  constexpr uint32_t kTileB = kBlock * DM * 2;
  const uint32_t sQ = smem_u32(smem), sG = sQ + kTileB;
  const uint32_t sKV = sG + kTileB;  // [2] x (K tile, V tile)

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int Sq = a.Sq, Sk = a.Sk, D = a.D;
  // the last q tile meets the most key tiles: launch it first
  const int q0 = ((Sq + kBlock - 1) / kBlock - 1 - (int)blockIdx.y) * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;  // this warp's q rows in the tile
  const Lanes<C> L(lane);

  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const bf* kp = static_cast<const bf*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const bf* vp = static_cast<const bf*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const bf* gp = static_cast<const bf*>(a.g) + b * a.gs[0] + h * a.gs[2];

  const int r0 = q0 + m0 + g;  // fragment rows r0 and r0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const long long o = (long long)bh * Sq + row;
    lse2[i] = row < Sq ? a.lse[o] * kLog2e : 0.f;
    dl[i] = row < Sq ? a.delta[o] : 0.f;
  }

  float dq[DM / 8][4];
#pragma unroll
  for (int j = 0; j < DM / 8; ++j)
    dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  // keys past k_end are masked for every row of the tile: skip their tiles
  const int nkt = (key_end(a, q0) + kBlock - 1) / kBlock;
  if (nkt > 0) {
    load_tile_async<DM>(sQ, qp, a.qs[1], q0, Sq, D);
    load_tile_async<DM>(sG, gp, a.gs[1], q0, Sq, D);
    load_tile_async<DM>(sKV, kp, a.ks[1], 0, Sk, D);
    load_tile_async<DM>(sKV + kTileB, vp, a.vs[1], 0, Sk, D);
    cp_async_commit();
  }

  for (int it = 0; it < nkt; ++it) {
    const int k0 = it * kBlock;
    const uint32_t sK = sKV + (it & 1) * 2 * kTileB, sV = sK + kTileB;
    if (it + 1 < nkt) {   // the next key tile loads while this one computes
      const uint32_t nK = sKV + ((it + 1) & 1) * 2 * kTileB;
      load_tile_async<DM>(nK, kp, a.ks[1], k0 + kBlock, Sk, D);
      load_tile_async<DM>(nK + kTileB, vp, a.vs[1], k0 + kBlock, Sk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // s = q k^T and dp = g v^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      uint32_t aq[4], ag[4];
      ld_a(aq, sQ, L, m0, kk);
      ld_a(ag, sG, L, m0, kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ld_b(bk, sK, L, np * 16, kk);
        ld_b(bv, sV, L, np * 16, kk);
        mma(s[2 * np], aq, bk[0], bk[1]);
        mma(s[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ag, bv[0], bv[1]);
        mma(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }

    // tiles wholly below the diagonal and inside both lengths skip the mask
    const bool full = k0 + kBlock <= Sk && q0 + kBlock <= Sq
        && (!a.causal || (long long)a.k_base + k0 + kBlock - 1
                             <= (long long)a.q_base + q0);
    if (full) dq_grad_tile<false>(s, dp, a, r0, k0, t, lse2, dl);
    else      dq_grad_tile<true>(s, dp, a, r0, k0, t, lse2, dl);
    uint32_t ads[4][4];   // ds rounded to k's dtype, as A of ds k
    to_a<8>(ads, s);

    // dq += ds k, k from ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < DM / 16; ++np) {
        uint32_t bk[4];
        ld_bt(bk, sK, L, kk * 16, np);
        mma(dq[2 * np], ads[kk], bk[0], bk[1]);
        mma(dq[2 * np + 1], ads[kk], bk[2], bk[3]);
      }
    __syncthreads();   // this key buffer is free for the tile after next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
    float* drow = a.dq + (((long long)b * Sq + row) * a.H + h) * D;
#pragma unroll
    for (int nb = 0; nb < DM / 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      if (c < D)
        *reinterpret_cast<float2*>(drow + c) =
            make_float2(dq[nb][2 * i], dq[nb][2 * i + 1]);
    }
  }
}

// kv tile: s^T (rows keys, cols q) -> p^T in s, ds^T in dp. lse and delta
// of the tile's q columns from shared memory.
template <bool kMask, int NB>
__device__ __forceinline__ void kv_grad_tile(float (&s)[NB][4],
                                             float (&dp)[NB][4],
                                             const Args& a, int kr0, int c0,
                                             int t, const float* lse_s,
                                             const float* dl_s) {
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int cc = nb * 8 + 2 * t;   // column within lse_s / dl_s
    const float2 lse = *reinterpret_cast<const float2*>(lse_s + cc);
    const float2 dlt = *reinterpret_cast<const float2*>(dl_s + cc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = (e & 1) ? lse.y : lse.x;
      const float d = (e & 1) ? dlt.y : dlt.x;
      bool live = true;
      if (kMask) {
        const int key = kr0 + 8 * (e >> 1), q = c0 + cc + (e & 1);
        live = key < a.Sk && q < a.Sq
            && (!a.causal || (long long)a.k_base + key
                              <= (long long)a.q_base + q);
      }
      const float p = live ? exp2f(fmaf(s[nb][e], sl2, -l * kLog2e)) : 0.f;
      dp[nb][e] = live ? p * (dp[nb][e] - d) * a.scale : 0.f;
      s[nb][e] = p;
    }
  }
}

template <int DM, bool kDQ>
__global__ void __launch_bounds__(kThreads) mma_bwd_kv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int C = DM / 8;
  constexpr uint32_t kTileB = kBlock * DM * 2;
  // q columns of one s^T sub-tile: at D 128 the dk / dv accumulators alone
  // take 128 registers a thread, so the 64-row q tile is taken in two
  // halves to bound s^T and dp^T (the kernel still spills up to 96 bytes)
  constexpr int NQ = DM <= 64 ? 64 : 32;
  const uint32_t sK = smem_u32(smem), sV = sK + kTileB;
  const uint32_t sQG = sV + kTileB;   // [2] x (Q tile, G tile)
  float* stats = reinterpret_cast<float*>(smem + 6 * kTileB);  // [2][2][64]
  const uint32_t sDS = sQG + 4 * kTileB + 4 * kBlock * 4;  // [key][q] bf16

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kBlock;  // key tile 0 meets the most q tiles
  const int Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;   // this warp's keys in the tile
  const Lanes<C> L(lane);
  const Lanes<8> l8(lane);      // the ds^T tile: 64 q columns a row
  const int kr0 = k0 + m0 + g;  // fragment rows kr0 and kr0 + 8

  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const bf* kp = static_cast<const bf*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const bf* vp = static_cast<const bf*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const bf* gp = static_cast<const bf*>(a.g) + b * a.gs[0] + h * a.gs[2];
  const float* lsep = a.lse + (long long)bh * Sq;
  const float* dlp = a.delta + (long long)bh * Sq;

  float dk[DM / 8][4], dv[DM / 8][4];
#pragma unroll
  for (int j = 0; j < DM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // q tiles wholly above the diagonal see no key of this tile
  const int q_start = first_q_tile(a, k0);
  const int nqt = (Sq - q_start + kBlock - 1) / kBlock;

  // one stage: the q / g tiles at q0 and their lse / delta
  auto load_stage = [&](int buf, int q0) {
    const uint32_t dst = sQG + buf * 2 * kTileB;
    load_tile_async<DM>(dst, qp, a.qs[1], q0, Sq, D);
    load_tile_async<DM>(dst + kTileB, gp, a.gs[1], q0, Sq, D);
    const int i = threadIdx.x & (kBlock - 1), which = threadIdx.x / kBlock;
    const bool in = q0 + i < Sq;
    const float* src = (which ? dlp : lsep) + (in ? q0 + i : 0);
    cp_async4(smem_u32(stats + (buf * 2 + which) * kBlock + i), src,
              in ? 4 : 0);
  };
  if (nqt > 0) {
    load_tile_async<DM>(sK, kp, a.ks[1], k0, Sk, D);
    load_tile_async<DM>(sV, vp, a.vs[1], k0, Sk, D);
    load_stage(0, q_start);
    cp_async_commit();
  }

  for (int it = 0; it < nqt; ++it) {
    const int q0 = q_start + it * kBlock, buf = it & 1;
    const uint32_t sQ = sQG + buf * 2 * kTileB, sG = sQ + kTileB;
    const float* lse_s = stats + buf * 2 * kBlock;
    const float* dl_s = lse_s + kBlock;
    if (it + 1 < nqt) {   // the next q tile loads while this one computes
      load_stage(buf ^ 1, q0 + kBlock);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool full = k0 + kBlock <= Sk && q0 + kBlock <= Sq
        && (!a.causal || (long long)a.k_base + k0 + kBlock - 1
                             <= (long long)a.q_base + q0);
#pragma unroll
    for (int sub = 0; sub < kBlock / NQ; ++sub) {
      const int qc = sub * NQ;   // first q column of the sub-tile
      // s^T = k q^T and dp^T = v g^T: 16 keys x NQ q columns a warp
      float s[NQ / 8][4], dp[NQ / 8][4];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk) {
        uint32_t ak[4], av[4];
        ld_a(ak, sK, L, m0, kk);
        ld_a(av, sV, L, m0, kk);
#pragma unroll
        for (int np = 0; np < NQ / 16; ++np) {
          uint32_t bq[4], bg[4];
          ld_b(bq, sQ, L, qc + np * 16, kk);
          ld_b(bg, sG, L, qc + np * 16, kk);
          mma(s[2 * np], ak, bq[0], bq[1]);
          mma(s[2 * np + 1], ak, bq[2], bq[3]);
          mma(dp[2 * np], av, bg[0], bg[1]);
          mma(dp[2 * np + 1], av, bg[2], bg[3]);
        }
      }
      if (full)
        kv_grad_tile<false>(s, dp, a, kr0, q0 + qc, t, lse_s + qc, dl_s + qc);
      else
        kv_grad_tile<true>(s, dp, a, kr0, q0 + qc, t, lse_s + qc, dl_s + qc);
      // p^T rounded to g's dtype, ds^T to q's: A of p^T g and ds^T q
      uint32_t ap[NQ / 16][4], ads[NQ / 16][4];
      to_a<NQ / 8>(ap, s);
      to_a<NQ / 8>(ads, dp);

      if constexpr (kDQ) {   // ds^T to shared memory for ds k
        unsigned char* ds_t = smem + (sDS - sK);
#pragma unroll
        for (int kq = 0; kq < NQ / 16; ++kq) {
          const int ch = (qc >> 3) + 2 * kq;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + g + 8 * (e & 1), c = ch + (e >> 1);
            *reinterpret_cast<uint32_t*>(ds_t + sw<8>(row, c) + 4 * t) =
                ads[kq][e];
          }
        }
      }

      // dv += p^T g, dk += ds^T q; g and q from ldmatrix.trans
#pragma unroll
      for (int kq = 0; kq < NQ / 16; ++kq)
#pragma unroll
        for (int np = 0; np < DM / 16; ++np) {
          uint32_t bg[4], bq[4];
          ld_bt(bg, sG, L, qc + kq * 16, np);
          ld_bt(bq, sQ, L, qc + kq * 16, np);
          mma(dv[2 * np], ap[kq], bg[0], bg[1]);
          mma(dv[2 * np + 1], ap[kq], bg[2], bg[3]);
          mma(dk[2 * np], ads[kq], bq[0], bq[1]);
          mma(dk[2 * np + 1], ads[kq], bq[2], bq[3]);
        }
    }

    if constexpr (kDQ) {
      __syncthreads();   // every warp's ds^T is in shared memory
      // this tile's dq contribution to q rows m0..m0+15: ds (16 x 64 keys)
      // times k (64 keys x D), 64 columns of D at a time
      const int qr0 = q0 + m0 + g;
#pragma unroll
      for (int dc = 0; dc < DM / 64; ++dc) {
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // ds (q rows, keys) as A: ldmatrix.trans of ds^T (row key, q
          // contiguous) at keys kk * 16, q chunk pair `warp`, whose lane
          // rows and chunks are those of a transposed B
          uint32_t ads[4];
          ldsm_t(ads, sDS + kk * 16 * 8 * 16 + (l8.b ^ (warp << 5)));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bk[4];
            ld_bt(bk, sK, L, kk * 16, dc * 4 + np);
            mma(acc[2 * np], ads, bk[0], bk[1]);
            mma(acc[2 * np + 1], ads, bk[2], bk[3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = qr0 + 8 * i;
          if (row >= Sq) continue;
          float* drow = a.dq + (((long long)b * Sq + row) * a.H + h) * D;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int c = dc * 64 + nb * 8 + 2 * t;
            if (c < D)
              atomicAdd(reinterpret_cast<float2*>(drow + c),
                        make_float2(acc[nb][2 * i], acc[nb][2 * i + 1]));
          }
        }
      }
    }
    __syncthreads();   // this stage's buffers (and ds^T) are free
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + 8 * i;
    if (key >= Sk) continue;
    const long long off = (((long long)b * Sk + key) * a.H + h) * D;
#pragma unroll
    for (int nb = 0; nb < DM / 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      if (c < D) {
        *reinterpret_cast<float2*>(a.dk + off + c) =
            make_float2(dk[nb][2 * i], dk[nb][2 * i + 1]);
        *reinterpret_cast<float2*>(a.dv + off + c) =
            make_float2(dv[nb][2 * i], dv[nb][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

// rows [row0, row0 + kBlock) of one head of a [B, S, H, D] tensor into a
// [kBlock][ld] f32 tile; rows at or past n are zero
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src,
                                          long long row_stride, int row0,
                                          int n, int D) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int row = row0 + r;
    dst[r * ld + c] = row < n ? src[(long long)row * row_stride + c] : 0.f;
  }
}

// DM: head_dim bucket (64 or 128) sizing the per-thread accumulators.
template <int DM, bool kDQ>
__global__ void __launch_bounds__(kThreads) bwd_kv_kernel(Args a) {
  extern __shared__ float smemf[];
  const int D = a.D, DP = D + 1;  // padded rows: no bank conflicts
  float* Ks = smemf;              // [kBlock][DP] this block's keys
  float* Vs = Ks + kBlock * DP;   // [kBlock][DP]
  float* Qs = Vs + kBlock * DP;   // [kBlock][DP] the q tile (dq staging)
  float* Gs = Qs + kBlock * DP;   // [kBlock][DP]
  float* Ps = Gs + kBlock * DP;   // [key][q] p
  float* Ss = Ps + kBlock * kPP;  // [key][q] ds
  float* lse_s = Ss + kBlock * kPP;  // [kBlock]
  float* dl_s = lse_s + kBlock;      // [kBlock]

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x;
  const int r = tid >> 1;      // key row of the tile (q row in the dq phase)
  const int half = tid & 1;    // which q rows / columns of the row it owns
  const int Sq = a.Sq, Sk = a.Sk;

  const float* qp = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const float* kp = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const float* vp = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const float* gp = static_cast<const float*>(a.g) + b * a.gs[0] + h * a.gs[2];
  const float* lsep = a.lse + (long long)bh * Sq;
  const float* dlp = a.delta + (long long)bh * Sq;

  load_tile(Ks, DP, kp, a.ks[1], k0, Sk, D);
  load_tile(Vs, DP, vp, a.vs[1], k0, Sk, D);

  float dk[DM / 2], dv[DM / 2];
#pragma unroll
  for (int j = 0; j < DM / 2; ++j) dk[j] = dv[j] = 0.f;
  const int nd = D / 2;
  const int kj = k0 + r;
  const long long k_pos = (long long)a.k_base + kj;

  for (int q0 = first_q_tile(a, k0); q0 < Sq; q0 += kBlock) {
    __syncthreads();   // the previous tile's Qs / Gs / Ps / Ss are free
    load_tile(Qs, DP, qp, a.qs[1], q0, Sq, D);
    load_tile(Gs, DP, gp, a.gs[1], q0, Sq, D);
    for (int i = tid; i < kBlock; i += kThreads) {
      const int qi = q0 + i;
      lse_s[i] = qi < Sq ? lsep[qi] : 0.f;
      dl_s[i] = qi < Sq ? dlp[qi] : 0.f;
    }
    __syncthreads();

    // s = k . q and dp = v . g of this key row against q rows half + 2i
    float s[kBlock / 2], dp[kBlock / 2];
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float kc = Ks[r * DP + c];
      const float vc = Vs[r * DP + c];
#pragma unroll
      for (int i = 0; i < kBlock / 2; ++i) {
        s[i] = fmaf(kc, Qs[(half + 2 * i) * DP + c], s[i]);
        dp[i] = fmaf(vc, Gs[(half + 2 * i) * DP + c], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) {
      const int ii = half + 2 * i;
      const int qi = q0 + ii;
      const bool live = kj < Sk && qi < Sq
          && (!a.causal || k_pos <= (long long)a.q_base + qi);
      const float p = live ? expf(s[i] * a.scale - lse_s[ii]) : 0.f;
      const float ds = live ? p * (dp[i] - dl_s[ii]) * a.scale : 0.f;
      Ps[r * kPP + ii] = p;
      Ss[r * kPP + ii] = ds;
    }
    __syncwarp();      // key row r's p and ds come from this thread pair

    // dv += p^T g, dk += ds^T q over the tile's q rows
    const int qn = min(kBlock, Sq - q0);
    for (int ii = 0; ii < qn; ++ii) {
      const float p = Ps[r * kPP + ii];
      const float ds = Ss[r * kPP + ii];
      const float* grow = Gs + ii * DP + half;
      const float* qrow = Qs + ii * DP + half;
#pragma unroll
      for (int j = 0; j < DM / 2; ++j)
        if (j < nd) {
          dv[j] = fmaf(p, grow[2 * j], dv[j]);
          dk[j] = fmaf(ds, qrow[2 * j], dk[j]);
        }
    }

    if constexpr (kDQ) {
      __syncthreads();   // every key row's ds is in Ss; Qs is read no more
      // this tile's dq contribution, row r of the q tile: sum over keys of
      // ds[key][r] * k[key]
      float dq[DM / 2];
#pragma unroll
      for (int j = 0; j < DM / 2; ++j) dq[j] = 0.f;
      const int kn = min(kBlock, Sk - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float ds = Ss[kk * kPP + r];
        const float* krow = Ks + kk * DP + half;
#pragma unroll
        for (int j = 0; j < DM / 2; ++j)
          if (j < nd) dq[j] = fmaf(ds, krow[2 * j], dq[j]);
      }
#pragma unroll
      for (int j = 0; j < DM / 2; ++j)
        if (j < nd) Qs[r * DP + half + 2 * j] = dq[j];
      __syncthreads();
      // coalesced: consecutive threads add consecutive columns of a row
      for (int i = tid; i < kBlock * D; i += kThreads) {
        const int rr = i / D, c = i - rr * D;
        const int qi = q0 + rr;
        if (qi < Sq)
          atomicAdd(a.dq + (((long long)b * Sq + qi) * a.H + h) * D + c,
                    Qs[rr * DP + c]);
      }
    }
  }

  if (kj < Sk) {
    const long long off = (((long long)b * Sk + kj) * a.H + h) * D + half;
#pragma unroll
    for (int j = 0; j < DM / 2; ++j)
      if (j < nd) {
        a.dk[off + 2 * j] = dk[j];
        a.dv[off + 2 * j] = dv[j];
      }
  }
}

template <int DM>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Args a) {
  extern __shared__ float smemf[];
  const int D = a.D, DP = D + 1;
  float* Qs = smemf;              // [kBlock][DP] this block's q rows
  float* Gs = Qs + kBlock * DP;   // [kBlock][DP]
  float* Ks = Gs + kBlock * DP;   // [kBlock][DP] the key tile
  float* Vs = Ks + kBlock * DP;   // [kBlock][DP]
  float* Ss = Vs + kBlock * DP;   // [q][key] ds

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // the last q tile meets the most key tiles: launch it first
  const int q0 = ((a.Sq + kBlock - 1) / kBlock - 1 - (int)blockIdx.y)
      * kBlock;
  const int tid = threadIdx.x;
  const int r = tid >> 1;      // q row of the tile
  const int half = tid & 1;    // which keys / columns of the row it owns
  const int Sq = a.Sq, Sk = a.Sk;

  const float* qp = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const float* kp = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const float* vp = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const float* gp = static_cast<const float*>(a.g) + b * a.gs[0] + h * a.gs[2];

  load_tile(Qs, DP, qp, a.qs[1], q0, Sq, D);
  load_tile(Gs, DP, gp, a.gs[1], q0, Sq, D);
  const int q_row = q0 + r;
  const long long q_pos = (long long)a.q_base + q_row;
  const float lse = q_row < Sq ? a.lse[(long long)bh * Sq + q_row] : 0.f;
  const float delta = q_row < Sq ? a.delta[(long long)bh * Sq + q_row] : 0.f;

  float dq[DM / 2];
#pragma unroll
  for (int j = 0; j < DM / 2; ++j) dq[j] = 0.f;
  const int nd = D / 2;

  // keys past k_end are masked for every row of the tile: skip their tiles
  const int k_end = key_end(a, q0);
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();   // the previous key tile is no longer read
    load_tile(Ks, DP, kp, a.ks[1], k0, Sk, D);
    load_tile(Vs, DP, vp, a.vs[1], k0, Sk, D);
    __syncthreads();

    float s[kBlock / 2], dp[kBlock / 2];
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qc = Qs[r * DP + c];
      const float gc = Gs[r * DP + c];
#pragma unroll
      for (int i = 0; i < kBlock / 2; ++i) {
        s[i] = fmaf(qc, Ks[(half + 2 * i) * DP + c], s[i]);
        dp[i] = fmaf(gc, Vs[(half + 2 * i) * DP + c], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) {
      const int jj = half + 2 * i;
      const int kj = k0 + jj;
      const bool live = kj < Sk && q_row < Sq
          && (!a.causal || (long long)a.k_base + kj <= q_pos);
      const float p = live ? expf(s[i] * a.scale - lse) : 0.f;
      const float ds = live ? p * (dp[i] - delta) * a.scale : 0.f;
      Ss[r * kPP + jj] = ds;
    }
    __syncwarp();      // row r's ds comes from this thread pair

    const int kn = min(kBlock, Sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float ds = Ss[r * kPP + kk];
      const float* krow = Ks + kk * DP + half;
#pragma unroll
      for (int j = 0; j < DM / 2; ++j)
        if (j < nd) dq[j] = fmaf(ds, krow[2 * j], dq[j]);
    }
  }

  if (q_row < Sq) {
    float* drow = a.dq + (((long long)b * Sq + q_row) * a.H + h) * D + half;
#pragma unroll
    for (int j = 0; j < DM / 2; ++j)
      if (j < nd) drow[2 * j] = dq[j];
  }
}

// dynamic shared memory of kernel `kind` on route `dtype` at head dim D
size_t smem_bytes(int kind, int dtype, int D) {
  if (dtype == 1) {
    const size_t tile = (size_t)kBlock * (D <= 64 ? 64 : 128) * 2;
    if (kind == kKindDq) return 6 * tile;   // Q, G, 2 x (K, V)
    // K, V, 2 x (Q, G), 2 x (lse, delta), the one pass's ds^T
    return 6 * tile + 4 * kBlock * sizeof(float)
        + (kind == kKindFused ? kBlock * kBlock * 2 : 0);
  }
  const size_t tile = (size_t)kBlock * (D + 1), pair = (size_t)kBlock * kPP;
  return sizeof(float) * (kind == kKindDq ? 4 * tile + pair
                                          : 4 * tile + 2 * pair + 2 * kBlock);
}

template <int DM>
int launch(int kind, int dtype, const Args& a, int B, cudaStream_t stream) {
  void (*kern)(Args);
  if (dtype == 1)
    kern = kind == kKindDq      ? mma_bwd_dq_kernel<DM>
         : kind == kKindFused   ? mma_bwd_kv_kernel<DM, true>
                                : mma_bwd_kv_kernel<DM, false>;
  else
    kern = kind == kKindDq      ? bwd_dq_kernel<DM>
         : kind == kKindFused   ? bwd_kv_kernel<DM, true>
                                : bwd_kv_kernel<DM, false>;
  // blockIdx.y walks the tiles, blockIdx.x the (batch, head) pairs
  const int tiles = ((kind == kKindDq ? a.Sq : a.Sk) + kBlock - 1) / kBlock;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kind, dtype, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B * a.H, tiles), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 = one pass (dq, dk, dv; dq must hold zeros), 1 = dq pass,
// 2 = dk/dv pass. dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores; every operand 16-byte aligned, strides multiples of 8). Strides
// are in elements: (batch, seq, head) for each of q, k, v, g. Returns
// cudaGetLastError() of the launch (0 when there is nothing to launch).
extern "C" int mv_flash_bwd(int kind, const void* q, const void* k,
                            const void* v, const void* g, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            int dtype, int B, int H, int Sq, int Sk, int D,
                            const long long* q_strides,
                            const long long* k_strides,
                            const long long* v_strides,
                            const long long* g_strides, int causal,
                            float scale, int q_base, int k_base,
                            void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || B <= 0 || H <= 0 || Sq < 0
      || Sk < 0 || kind < kKindFused || kind > kKindDkv)
    return (int)cudaErrorInvalidValue;
  // an empty grid: nothing to compute (the wrapper zeroes dq and dk / dv)
  if ((kind == kKindDq && Sq == 0) || (kind != kKindDq && Sk == 0)) return 0;
  Args a;
  a.q = q; a.k = k; a.v = v; a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = q_strides[i]; a.ks[i] = k_strides[i];
    a.vs[i] = v_strides[i]; a.gs[i] = g_strides[i];
  }
  a.causal = causal; a.scale = scale; a.q_base = q_base; a.k_base = k_base;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1
      && !(async_copy_ok(q, q_strides) && async_copy_ok(k, k_strides)
           && async_copy_ok(v, v_strides) && async_copy_ok(g, g_strides)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch<64>(kind, dtype, a, B, st)
                 : launch<128>(kind, dtype, a, B, st);
}

// the dynamic shared memory (bytes) that mv_flash_bwd gives a kernel
extern "C" int mv_flash_bwd_smem_bytes(int kind, int dtype, int D) {
  return (int)smem_bytes(kind, dtype, D);
}
