// Flash-attention forward for Hopper (sm_90a): the CUDA counterpart of the
// JAX package's two Pallas forward kernels,
//   multiverso_tpu/ops/flash_attention.py::_fa_kernel_single (one key block)
//   multiverso_tpu/ops/flash_attention.py::_fa_kernel        (online softmax)
// The one-block kernel was a TPU VMEM specialisation; here one loop over key
// tiles inside the thread block covers both regimes.
//
// Contract (identical to the Pallas kernels'):
//   q [B, Sq, H, D], k/v [B, Sk, H, D], read through the given strides (the
//   last dim must be contiguous), f32 or bf16;
//   out [B, Sq, H, D] contiguous: normalized and in the input dtype, or the
//   unnormalized f32 accumulator (ring partials);
//   m, l [B, H, Sq] f32: the row max of s * scale and the row sum of
//   exp(s * scale - m), in natural units.
//   Causal masking is in global positions: key j of row i is live when
//   k_base + j <= q_base + i. Masked scores are the -1e30 sentinel, not
//   -inf, with the same guards as the Pallas kernels, so a fully masked row
//   gives m = -1e30, l = 0 and out = 0, never NaN.
//   p is rounded to v's dtype before the PV product (_fa_kernel:145); l sums
//   the unrounded p.
//
// What bounds it on this card: two products of 2 * D flops per live (row,
// key) pair, and each input read once. At the training path's shapes (B 8
// x S 1024 and B 4 x S 2048, causal, H 12, head_dim 64) the bytes (q, k, v
// in, out, m, l out over 3.35 TB/s) and the flops (over the tensor cores'
// 989 TFLOP/s in bf16) bound it within 2x of each other: ~0.015 ms (bytes)
// and ~0.026 ms (operations). No [Sq, Sk] matrix reaches device memory,
// each K/V tile is read once per q tile, and key tiles wholly above the
// causal diagonal or past Sk are never loaded (causal work halves).
//
// Two routes, chosen by the dtype (never by a failure):
//
// bf16: the tensor-core kernel (mma_fwd_kernel). One 4-warp block per
//   (batch * head, 64-row q tile), each warp owning 16 q rows. Q goes
//   through a swizzled shared-memory tile once (16-byte cp.async) and stays
//   in registers as ldmatrix A fragments; K and V tiles of 64 keys are
//   double-buffered with 16-byte cp.async, zero-filled past Sk and past D
//   (source size 0), the next tile loading while this one computes.
//   s = q k^T is mma.sync.m16n8k16 (bf16 in, f32 accumulate) with k from
//   ldmatrix. The online softmax runs on s's f32 accumulator fragment: a
//   thread holds two rows, whose max and sum are reduced across the quad
//   of lanes that share them with shuffles; exponents are ex2.approx with
//   scale * log2(e) folded in, and masked terms are selected, never
//   multiplied (0 * inf is NaN). s's fragment has the layout of the next
//   product's A operand, so p is rounded to bf16 in registers and
//   o += p v takes v through ldmatrix.trans; o stays in registers (32 f32
//   a thread at D 64, 64 at D 128). The mask is compiled only into tiles
//   that cross the causal diagonal or Sk (softmax_tile<kMask>), and causal
//   q tiles run longest first: the last q tile has the lowest block index.
//   Head dims: built for a D bucket of 64 or 128; a D that is a multiple
//   of 8 below its bucket is zero-filled up to it in shared memory. The
//   16-byte copies need each operand 16-byte aligned with batch, seq and
//   head strides that are multiples of 8 elements (the wrapper checks; the
//   entry point refuses others with cudaErrorMisalignedAddress).
//
// f32: the CUDA-core kernel (flash_fwd_kernel). On the tensor cores f32
//   would be TF32, which cannot hold f32 accuracy. One 128-thread block
//   per (batch * head, 64-row q tile), K/V tiles of 64 keys staged through
//   shared memory, scores and p v on the CUDA cores with fmaf, two threads
//   a q row, the running max, sum and accumulator in registers.

#include "mma_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// dynamic shared memory of the route for `dtype` at head dim D
size_t smem_bytes(int dtype, int D) {
  if (dtype == 1)   // Q, 2 x (K, V), bf16 tiles of the D bucket
    return (size_t)5 * kBlock * (D <= 64 ? 64 : 128) * 2;
  return sizeof(float) * ((size_t)2 * kBlock * (D + 1) + (size_t)kBlock * D
                          + (size_t)kBlock * (kBlock + 1));
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

// DM: head_dim bucket (64 or 128) sizing the per-thread accumulator.
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int H, int Sq, int Sk, int D,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 int causal, int normalize, float scale,
                 int q_base, int k_base) {
  extern __shared__ float smem[];
  const int DP = D + 1;                     // padded row: no bank conflicts
  float* Qs = smem;                         // [kBlock][DP]
  float* Ks = Qs + kBlock * DP;             // [kBlock][DP]
  float* Vs = Ks + kBlock * DP;             // [kBlock][D]
  float* Ps = Vs + kBlock * D;              // [kBlock][kBlock + 1]
  constexpr int PP = kBlock + 1;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x;
  const int r = tid >> 1;       // this thread's q row within the tile
  const int half = tid & 1;     // which keys / columns of the row it owns

  const float* qp = q + b * qsb + h * qsh;
  const float* kp = k + b * ksb + h * ksh;
  const float* vp = v + b * vsb + h * vsh;

  for (int i = tid; i < kBlock * D; i += kThreads) {
    const int rr = i / D, c = i - rr * D;
    const int qi = q0 + rr;
    Qs[rr * DP + c] = qi < Sq ? qp[qi * qss + c] : 0.f;
  }

  float acc[DM / 2];
#pragma unroll
  for (int j = 0; j < DM / 2; ++j) acc[j] = 0.f;
  float m_run = kNegInf;
  float l_run = 0.f;
  const int nd = D / 2;
  const int q_row = q0 + r;
  const long long q_pos = (long long)q_base + q_row;

  // keys past k_end are masked for every row of the tile: skip their tiles
  const int k_end = key_end(Sq, Sk, q_base, k_base, causal, q0);

  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();   // the previous tile's Ks/Vs are no longer read
    for (int i = tid; i < kBlock * D; i += kThreads) {
      const int kr = i / D, c = i - kr * D;
      const int kj = k0 + kr;
      const bool in = kj < Sk;
      Ks[kr * DP + c] = in ? kp[kj * kss + c] : 0.f;
      Vs[kr * D + c] = in ? vp[kj * vss + c] : 0.f;
    }
    __syncthreads();

    // scores of this row against keys half, half + 2, ...
    float s[kBlock / 2];
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) s[i] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = Qs[r * DP + c];
#pragma unroll
      for (int i = 0; i < kBlock / 2; ++i)
        s[i] = fmaf(qv, Ks[(half + 2 * i) * DP + c], s[i]);
    }
    float m_blk = kNegInf;
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) {
      const int kj = k0 + half + 2 * i;
      const bool live = kj < Sk && (!causal || (long long)k_base + kj <= q_pos);
      s[i] = live ? s[i] * scale : kNegInf;
      m_blk = fmaxf(m_blk, s[i]);
    }
    m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, 1));
    const float m_new = fmaxf(m_run, m_blk);
    const float m_safe = m_new <= kNegInf ? 0.f : m_new;
    const float corr = m_run > kNegInf ? expf(m_run - m_safe) : 0.f;
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) {
      const float p = s[i] > kNegInf ? expf(s[i] - m_safe) : 0.f;
      p_sum += p;
      Ps[r * PP + half + 2 * i] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l_run = l_run * corr + p_sum;
    m_run = m_new;
    __syncwarp();      // row r's P is written by this thread pair only

#pragma unroll
    for (int j = 0; j < DM / 2; ++j) acc[j] *= corr;
    const int kn = min(kBlock, Sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float p = Ps[r * PP + kk];
      const float* vrow = Vs + kk * D + half;
#pragma unroll
      for (int j = 0; j < DM / 2; ++j)
        if (j < nd) acc[j] = fmaf(p, vrow[2 * j], acc[j]);
    }
  }

  if (q_row < Sq) {
    if (half == 0) {
      m_out[(long long)bh * Sq + q_row] = m_run;
      l_out[(long long)bh * Sq + q_row] = l_run;
    }
    const float denom = normalize ? fmaxf(l_run, 1e-20f) : 1.f;
    float* orow = out + (((long long)b * Sq + q_row) * H + h) * D + half;
#pragma unroll
    for (int j = 0; j < DM / 2; ++j)
      if (j < nd) orow[2 * j] = normalize ? acc[j] / denom : acc[j];
  }
}

template <int DM>
int launch(const void* q, const void* k, const void* v, void* out, void* m,
           void* l, int B, int H, int Sq, int Sk, int D,
           const long long* qs, const long long* ks, const long long* vs,
           int causal, int normalize, float scale, int q_base, int k_base,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(0, D);
  auto kern = flash_fwd_kernel<DM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBlock - 1) / kBlock, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(l), H, Sq, Sk, D,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      causal, normalize, scale, q_base, k_base);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* m, void* l, int B, int H, int Sq, int Sk, int D,
               const long long* qs, const long long* ks, const long long* vs,
               int causal, int normalize, float scale, int q_base,
               int k_base, cudaStream_t stream) {
  if (D <= 64)
    return launch<64>(q, k, v, out, m, l, B, H, Sq, Sk, D, qs, ks, vs, causal,
                      normalize, scale, q_base, k_base, stream);
  return launch<128>(q, k, v, out, m, l, B, H, Sq, Sk, D, qs, ks, vs, causal,
                     normalize, scale, q_base, k_base, stream);
}


// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

// 2^x as one special-function-unit instruction, subnormal results flushed
// to 0 (a p below 2^-126 adds nothing to a row sum that holds 1). At
// head_dim 64 a tile takes one exponential per 256 flops of its products,
// so the exponentials weigh on the kernel, and exp2f wraps the same
// instruction in subnormal handling.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  void* out;   // bf16 (normalize) or f32
  float* m;
  float* l;
  int H, Sq, Sk, D;
  long long qs[3], ks[3], vs[3];  // (batch, seq, head) strides
  int causal, normalize;
  float scale;
  int q_base, k_base;
};

// Online softmax of a warp's 16 x 64 score tile (this thread: rows r0 and
// r0 + 8, columns 2 t, 2 t + 1 of each 8-key block): s becomes the
// unrounded p, the running max m (in units of s, unscaled) and this
// thread's share of the running sum l are updated, and o is rescaled.
// kMask: the tile crosses the causal diagonal or Sk, so every (row, key) is
// tested by position (zero-filled keys past Sk must not score 0).
template <bool kMask, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&o)[NO][4],
                                             const FwdArgs& a, int r0,
                                             int k0, int t, float sl2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask) {
        const int row = r0 + 8 * (e >> 1), key = k0 + nb * 8 + 2 * t + (e & 1);
        const bool live = key < a.Sk
            && (!a.causal || (long long)a.k_base + key
                              <= (long long)a.q_base + row);
        s[nb][e] = live ? s[nb][e] : kNegInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    }
  float msl2[2], corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    // a row with no live key yet keeps the sentinel: exponents from 0
    const float m_safe = m_new <= kNegInf ? 0.f : m_new;
    msl2[i] = m_safe * sl2;
    corr[i] = m[i] > kNegInf ? exp2_approx(fmaf(m[i], sl2, -msl2[i])) : 0.f;
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = exp2_approx(fmaf(s[nb][e], sl2, -msl2[i]));
      s[nb][e] = (!kMask || s[nb][e] > kNegInf) ? p : 0.f;
      l[i] += s[nb][e];
    }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// DM: head_dim bucket (64 or 128); OutT: bf16 (normalized) or f32
template <int DM, typename OutT>
__global__ void __launch_bounds__(kThreads) mma_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char tiles[];
  constexpr int C = DM / 8;
  constexpr uint32_t kTileB = kBlock * DM * 2;
  const uint32_t sQ = smem_u32(tiles);
  const uint32_t sKV = sQ + kTileB;   // [2] x (K tile, V tile)

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int Sq = a.Sq, Sk = a.Sk, D = a.D;
  // the last q tile meets the most key tiles: launch it first
  const int q0 = ((Sq + kBlock - 1) / kBlock - 1 - (int)blockIdx.y) * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;     // this warp's q rows in the tile
  const int r0 = q0 + m0 + g;   // fragment rows r0 and r0 + 8
  const Lanes<C> L(lane);

  using bf = __nv_bfloat16;
  const bf* qp = a.q + b * a.qs[0] + h * a.qs[2];
  const bf* kp = a.k + b * a.ks[0] + h * a.ks[2];
  const bf* vp = a.v + b * a.vs[0] + h * a.vs[2];

  float o[DM / 8][4];
#pragma unroll
  for (int j = 0; j < DM / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;

  // keys past key_end are masked for every row of the tile: skip their
  // tiles
  const int nkt = (key_end(a, q0) + kBlock - 1) / kBlock;
  uint32_t aq[DM / 16][4];   // this warp's q rows as A fragments
  if (nkt > 0) {
    load_tile_async<DM>(sQ, qp, a.qs[1], q0, Sq, D);
    cp_async_commit();
    load_tile_async<DM>(sKV, kp, a.ks[1], 0, Sk, D);
    load_tile_async<DM>(sKV + kTileB, vp, a.vs[1], 0, Sk, D);
    cp_async_commit();
    cp_async_wait<1>();   // Q is in; the first K / V tile may still load
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) ld_a(aq[kk], sQ, L, m0, kk);
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

    // s = q k^T: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ld_b(bk, sK, L, np * 16, kk);
        mma(s[2 * np], aq[kk], bk[0], bk[1]);
        mma(s[2 * np + 1], aq[kk], bk[2], bk[3]);
      }

    // tiles wholly below the diagonal and inside Sk skip the mask
    const bool full = k0 + kBlock <= Sk
        && (!a.causal || (long long)a.k_base + k0 + kBlock - 1
                             <= (long long)a.q_base + q0);
    if (full) softmax_tile<false>(s, m, l, o, a, r0, k0, t, sl2);
    else      softmax_tile<true>(s, m, l, o, a, r0, k0, t, sl2);
    uint32_t ap[4][4];   // p rounded to bf16, as A of p v
    to_a<8>(ap, s);

    // o += p v, v from ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < DM / 16; ++np) {
        uint32_t bv[4];
        ld_bt(bv, sV, L, kk * 16, np);
        mma(o[2 * np], ap[kk], bv[0], bv[1]);
        mma(o[2 * np + 1], ap[kk], bv[2], bv[3]);
      }
    __syncthreads();   // this key buffer is free for the tile after next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the row sum over the quad's lanes (every lane takes part)
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
    const long long so = (long long)bh * Sq + row;
    if (t == 0) {
      a.m[so] = m[i] <= kNegInf ? kNegInf : m[i] * a.scale;
      a.l[so] = li;
    }
    const float denom = a.normalize ? fmaxf(li, 1e-20f) : 1.f;
    OutT* orow = static_cast<OutT*>(a.out)
        + (((long long)b * Sq + row) * a.H + h) * D;
#pragma unroll
    for (int nb = 0; nb < DM / 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      if (c < D)
        store2(orow + c, o[nb][2 * i] / denom, o[nb][2 * i + 1] / denom);
    }
  }
}

template <int DM, typename OutT>
int launch_mma(const FwdArgs& a, int B, cudaStream_t stream) {
  // blockIdx.y walks the q tiles, blockIdx.x the (batch, head) pairs
  const int tiles = (a.Sq + kBlock - 1) / kBlock;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(1, a.D);
  auto kern = mma_fwd_kernel<DM, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B * a.H, tiles), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; every
// operand 16-byte aligned, strides multiples of 8). Strides are in
// elements: (batch, seq, head) for each of q, k, v. Returns
// cudaGetLastError() of the launch (0 when there is nothing to launch).
extern "C" int mv_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* m, void* l, int dtype, int B,
                            int H, int Sq, int Sk, int D,
                            const long long* q_strides,
                            const long long* k_strides,
                            const long long* v_strides, int causal,
                            int normalize, float scale, int q_base,
                            int k_base, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || B <= 0 || H <= 0 || Sq < 0
      || Sk < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, m, l, B, H, Sq, Sk, D, q_strides,
                      k_strides, v_strides, causal, normalize, scale, q_base,
                      k_base, st);
  if (!(async_copy_ok(q, q_strides) && async_copy_ok(k, k_strides)
        && async_copy_ok(v, v_strides)))
    return (int)cudaErrorMisalignedAddress;
  FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = out;
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = q_strides[i]; a.ks[i] = k_strides[i]; a.vs[i] = v_strides[i];
  }
  a.causal = causal; a.normalize = normalize; a.scale = scale;
  a.q_base = q_base; a.k_base = k_base;
  if (normalize)
    return D <= 64 ? launch_mma<64, __nv_bfloat16>(a, B, st)
                   : launch_mma<128, __nv_bfloat16>(a, B, st);
  return D <= 64 ? launch_mma<64, float>(a, B, st)
                 : launch_mma<128, float>(a, B, st);
}

// the dynamic shared memory (bytes) that mv_flash_fwd gives a launch
extern "C" int mv_flash_fwd_smem_bytes(int dtype, int D) {
  return (int)smem_bytes(dtype, D);
}
