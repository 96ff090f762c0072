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
//   m, l [B, H, Sq] f32: the row max and the row sum of exp(s - m).
//   Causal masking is in global positions: key j of row i is live when
//   k_base + j <= q_base + i. Masked scores are the -1e30 sentinel, not
//   -inf, with the same guards as the Pallas kernels, so a fully masked row
//   gives m = -1e30, l = 0 and out = 0, never NaN.
//   p is rounded to v's dtype before the PV product (_fa_kernel:145); l sums
//   the unrounded p.
//
// What bounds it on this card: at the serving path's prefill shapes
// (Sq = Sk = 1024..1536, head_dim 64) attention does ~2*D flops per score
// for every byte it reads, so the bound is the tensor cores' FLOP rate, not
// memory. This first version is deliberately simple and keeps the FLOPs
// off the tensor cores: one 128-thread block per (batch*head, 64-row q
// tile), K/V tiles of 64 keys staged through shared memory as f32, scores
// and P*V on the CUDA cores with f32 accumulation, and the running max,
// sum and accumulator in registers. What the design does about the bound:
// the whole [Sq, Sk] score matrix never reaches device memory, each K/V
// tile is read once per q tile, and key tiles wholly above the causal
// diagonal or past Sk are never loaded (causal work halves). Moving the two
// products onto wgmma with TMA-fed tiles is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;   // two threads per q row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// DM: head_dim bucket (64 or 128) sizing the per-thread accumulator.
template <typename T, typename OutT, int DM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, OutT* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int H, int Sq, int Sk, int D,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 int causal, int normalize, float scale,
                 int q_base, int k_base) {
  extern __shared__ float smem[];
  const int DP = D + 1;                       // padded row: no bank conflicts
  float* Qs = smem;                           // [kBlockQ][DP]
  float* Ks = Qs + kBlockQ * DP;              // [kBlockK][DP]
  float* Vs = Ks + kBlockK * DP;              // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;               // [kBlockQ][kBlockK + 1]
  constexpr int PP = kBlockK + 1;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int r = tid >> 1;       // this thread's q row within the tile
  const int half = tid & 1;     // which keys / columns of the row it owns

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int rr = i / D, c = i - rr * D;
    const int qi = q0 + rr;
    Qs[rr * DP + c] = qi < Sq ? to_f32(qp[qi * qss + c]) : 0.f;
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
  int k_end = Sk;
  if (causal) {
    const int q_last = min(q0 + kBlockQ, Sq) - 1;
    const long long lim = (long long)q_base + q_last - k_base + 1;
    k_end = (int)max(0LL, min((long long)Sk, lim));
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();   // the previous tile's Ks/Vs are no longer read
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int kr = i / D, c = i - kr * D;
      const int kj = k0 + kr;
      const bool in = kj < Sk;
      Ks[kr * DP + c] = in ? to_f32(kp[kj * kss + c]) : 0.f;
      Vs[kr * D + c] = in ? to_f32(vp[kj * vss + c]) : 0.f;
    }
    __syncthreads();

    // scores of this row against keys half, half + 2, ...
    float s[kBlockK / 2];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) s[i] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = Qs[r * DP + c];
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i)
        s[i] = fmaf(qv, Ks[(half + 2 * i) * DP + c], s[i]);
    }
    float m_blk = kNegInf;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
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
    for (int i = 0; i < kBlockK / 2; ++i) {
      const float p = s[i] > kNegInf ? expf(s[i] - m_safe) : 0.f;
      p_sum += p;
      Ps[r * PP + half + 2 * i] = to_f32(from_f32<T>(p));
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l_run = l_run * corr + p_sum;
    m_run = m_new;
    __syncwarp();      // row r's P is written by this thread pair only

#pragma unroll
    for (int j = 0; j < DM / 2; ++j) acc[j] *= corr;
    const int kn = min(kBlockK, Sk - k0);
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
    OutT* orow = out + (((long long)b * Sq + q_row) * H + h) * D + half;
#pragma unroll
    for (int j = 0; j < DM / 2; ++j)
      if (j < nd) orow[2 * j] = from_f32<OutT>(normalize ? acc[j] / denom
                                                          : acc[j]);
  }
}

template <typename T, typename OutT, int DM>
int launch(const void* q, const void* k, const void* v, void* out, void* m,
           void* l, int B, int H, int Sq, int Sk, int D,
           const long long* qs, const long long* ks, const long long* vs,
           int causal, int normalize, float scale, int q_base, int k_base,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBlockQ * (D + 1)
                                       + (size_t)kBlockK * (D + 1)
                                       + (size_t)kBlockK * D
                                       + (size_t)kBlockQ * (kBlockK + 1));
  auto kern = flash_fwd_kernel<T, OutT, DM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<OutT*>(out),
      static_cast<float*>(m), static_cast<float*>(l), H, Sq, Sk, D,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      causal, normalize, scale, q_base, k_base);
  return (int)cudaGetLastError();
}

template <typename T, typename OutT>
int launch_d(const void* q, const void* k, const void* v, void* out, void* m,
             void* l, int B, int H, int Sq, int Sk, int D,
             const long long* qs, const long long* ks, const long long* vs,
             int causal, int normalize, float scale, int q_base, int k_base,
             cudaStream_t stream) {
  if (D <= 64)
    return launch<T, OutT, 64>(q, k, v, out, m, l, B, H, Sq, Sk, D, qs, ks,
                               vs, causal, normalize, scale, q_base, k_base,
                               stream);
  return launch<T, OutT, 128>(q, k, v, out, m, l, B, H, Sq, Sk, D, qs, ks, vs,
                              causal, normalize, scale, q_base, k_base,
                              stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements: (batch, seq,
// head) for each of q, k, v. Returns cudaGetLastError() of the launch.
extern "C" int mv_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* m, void* l, int dtype, int B,
                            int H, int Sq, int Sk, int D,
                            const long long* q_strides,
                            const long long* k_strides,
                            const long long* v_strides, int causal,
                            int normalize, float scale, int q_base,
                            int k_base, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || B <= 0 || H <= 0 || Sq < 0
      || Sk < 0)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float, float>(q, k, v, out, m, l, B, H, Sq, Sk, D,
                                  q_strides, k_strides, v_strides, causal,
                                  normalize, scale, q_base, k_base, st);
  if (dtype == 1) {
    if (normalize)
      return launch_d<__nv_bfloat16, __nv_bfloat16>(
          q, k, v, out, m, l, B, H, Sq, Sk, D, q_strides, k_strides,
          v_strides, causal, normalize, scale, q_base, k_base, st);
    return launch_d<__nv_bfloat16, float>(
        q, k, v, out, m, l, B, H, Sq, Sk, D, q_strides, k_strides, v_strides,
        causal, normalize, scale, q_base, k_base, st);
  }
  return (int)cudaErrorInvalidValue;
}
