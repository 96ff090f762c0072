// Flash-attention backward for Hopper (sm_90a): the CUDA counterpart of the
// JAX package's three Pallas backward kernels,
//   multiverso_tpu/ops/flash_attention.py::_bwd_fused_kernel (one pass, nk==1)
//   multiverso_tpu/ops/flash_attention.py::_bwd_dq_kernel    (dq pass)
//   multiverso_tpu/ops/flash_attention.py::_bwd_dkv_kernel   (dk/dv pass)
// Two CUDA kernels cover the three: bwd_kv_kernel is the dk/dv pass and,
// with kDQ, the one-pass kernel that also produces dq; bwd_dq_kernel is the
// dq pass.
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
//   Sq != Sk are masked here: nothing is padded.
//   dv += p^T g with p rounded to g's dtype (_bwd_dkv_kernel:451-453);
//   ds = p * (g v^T - delta) * scale, rounded to k's dtype before ds k
//   (dq) and to q's dtype before ds^T q (dk), as the Pallas kernels do.
//
// What bounds it on this card: the backward does four (dq, dk/dv passes)
// or five (one pass) products of 2 * D flops per live (row, key) pair and
// reads each input once, so at the training path's shapes (S 1024-2048,
// head_dim 64) the tensor cores' FLOP rate is the bound, not memory. This
// first version keeps the products on the CUDA cores with f32 accumulation,
// as flash_fwd.cu does; moving them onto wgmma is a later step. What the
// design does about the bound: no [Sq, Sk] matrix reaches device memory
// (p and ds are recomputed per tile from lse and delta), and tiles wholly
// above the causal diagonal are never visited, which halves causal work.
//
// Design. The TPU's sequential grid axis that carried an accumulator in
// VMEM becomes a loop inside one thread block:
//   bwd_kv_kernel: one 128-thread block per (batch * head, 64-key tile).
//     K and V of the tile stay in shared memory; the block walks the q
//     tiles from the causal diagonal on, recomputes p and ds for the
//     64 x 64 tile, and accumulates dk and dv in registers (thread pair
//     per key row). With kDQ (the one-pass kernel, K5's function) it also
//     forms the tile's dq contribution ds k, stages it in shared memory and
//     adds it to dq with f32 atomicAdd, coalesced, into a dq the wrapper
//     zeroed. Partial dq buffers per key tile would take nk times dq's size
//     (16 x 25 MB at the flagship's seq 1024) and a second pass; the atomics
//     are ~50 M adds a call, small beside the kernel's arithmetic. The cost:
//     the order of the (at most Sk / 64) adds into one dq element changes
//     from run to run, so dq is not bitwise reproducible; it differs from an
//     ordered sum by a few f32 ulps of the sum of |contributions|.
//   bwd_dq_kernel: one block per (batch * head, 64-row q tile), walking the
//     key tiles up to the causal diagonal and accumulating dq in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;     // q rows and keys per tile
constexpr int kThreads = 128;  // two threads per tile row
constexpr int kPP = kBlock + 1;  // padded row of the p / ds tiles
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and back: the Pallas kernels' .astype(dtype) before a dot
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [row0, row0 + kBlock) of one head of a [B, S, H, D] tensor into a
// [kBlock][ld] f32 tile; rows at or past n are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int n, int D) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int row = row0 + r;
    dst[r * ld + c] = row < n ? to_f32(src[(long long)row * row_stride + c])
                              : 0.f;
  }
}

// DM: head_dim bucket (64 or 128) sizing the per-thread accumulators.
template <typename T, int DM, bool kDQ>
__global__ void __launch_bounds__(kThreads) bwd_kv_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, DP = D + 1;  // padded rows: no bank conflicts
  float* Ks = smem;               // [kBlock][DP] this block's keys
  float* Vs = Ks + kBlock * DP;   // [kBlock][DP]
  float* Qs = Vs + kBlock * DP;   // [kBlock][DP] the q tile (dq staging)
  float* Gs = Qs + kBlock * DP;   // [kBlock][DP]
  float* Ps = Gs + kBlock * DP;   // [key][q] p rounded to g's dtype
  float* Ss = Ps + kBlock * kPP;  // [key][q] ds rounded to q's dtype
  float* lse_s = Ss + kBlock * kPP;  // [kBlock]
  float* dl_s = lse_s + kBlock;      // [kBlock]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x;
  const int r = tid >> 1;      // key row of the tile (q row in the dq phase)
  const int half = tid & 1;    // which q rows / columns of the row it owns
  const int Sq = a.Sq, Sk = a.Sk;

  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const T* gp = static_cast<const T*>(a.g) + b * a.gs[0] + h * a.gs[2];
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

  // q tiles wholly above the diagonal see no key of this tile: start at
  // the tile of the first row that sees key k0
  int q_start = 0;
  if (a.causal) {
    const long long first = (long long)a.k_base + k0 - a.q_base;
    q_start = first <= 0 ? 0 : (int)min((long long)Sq, first);
    q_start -= q_start % kBlock;
  }

  for (int q0 = q_start; q0 < Sq; q0 += kBlock) {
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
      Ps[r * kPP + ii] = round_to<T>(p);
      Ss[r * kPP + ii] = round_to<T>(ds);
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

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, DP = D + 1;
  float* Qs = smem;               // [kBlock][DP] this block's q rows
  float* Gs = Qs + kBlock * DP;   // [kBlock][DP]
  float* Ks = Gs + kBlock * DP;   // [kBlock][DP] the key tile
  float* Vs = Ks + kBlock * DP;   // [kBlock][DP]
  float* Ss = Vs + kBlock * DP;   // [q][key] ds rounded to k's dtype

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x;
  const int r = tid >> 1;      // q row of the tile
  const int half = tid & 1;    // which keys / columns of the row it owns
  const int Sq = a.Sq, Sk = a.Sk;

  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const T* gp = static_cast<const T*>(a.g) + b * a.gs[0] + h * a.gs[2];

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
  int k_end = Sk;
  if (a.causal) {
    const int q_last = min(q0 + kBlock, Sq) - 1;
    const long long lim = (long long)a.q_base + q_last - a.k_base + 1;
    k_end = (int)max(0LL, min((long long)Sk, lim));
  }

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
      Ss[r * kPP + jj] = round_to<T>(ds);
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

template <typename T, int DM>
int launch(int kind, const Args& a, int B, cudaStream_t stream) {
  const int D = a.D;
  const size_t tile = (size_t)kBlock * (D + 1);
  const size_t pair = (size_t)kBlock * kPP;
  if (kind == kKindDq) {
    const size_t smem = sizeof(float) * (4 * tile + pair);
    auto kern = bwd_dq_kernel<T, DM>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.Sq + kBlock - 1) / kBlock, B * a.H);
    kern<<<grid, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * (4 * tile + 2 * pair + 2 * kBlock);
  auto kern = kind == kKindFused ? bwd_kv_kernel<T, DM, true>
                                 : bwd_kv_kernel<T, DM, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + kBlock - 1) / kBlock, B * a.H);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int kind, const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64>(kind, a, B, stream);
  return launch<T, 128>(kind, a, B, stream);
}

}  // namespace

// kind: 0 = one pass (dq, dk, dv; dq must hold zeros), 1 = dq pass,
// 2 = dk/dv pass. dtype: 0 = float32, 1 = bfloat16. Strides are in
// elements: (batch, seq, head) for each of q, k, v, g. Returns
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(kind, a, B, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(kind, a, B, st);
  return (int)cudaErrorInvalidValue;
}
