"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``multiverso_tpu/ops/flash_attention.py``. The JAX module
runs two Pallas kernels for the forward, ``_fa_kernel_single`` (the whole
K/V in one block) and ``_fa_kernel`` (online softmax over key blocks);
here one CUDA kernel, ``csrc/flash_fwd.cu``, covers both, and
:func:`_fa_plain` beside it computes the same ``(out, m, l)`` as one full
softmax in PyTorch.

* :func:`flash_attention` — exact attention, O(seq) memory on the card.
* :func:`flash_attention_partial` — the un-normalised block
  ``(acc, m, l)`` with global position offsets, merged across blocks by
  :func:`merge_partials`.

Layout: ``[seq, heads, head_dim]`` as in the JAX package, with an optional
leading batch dim (which replaces JAX's ``vmap``). The kernel reads that
layout through its strides, so no transpose copy is made.

The wrapper takes the plain version for tensors on the CPU (the tests) and
the CUDA kernel for tensors on a CUDA device; there it launches the kernel
or raises, and never falls back. The JAX arguments ``block_q``,
``block_k``, ``interpret`` and ``precision`` are TPU knobs and are gone.
This slice ports the forward only: the backward kernels come with the
training slice, so these functions refuse inputs that require grad.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30

# launches of the CUDA kernel (the plain version is not counted), and the
# same launches keyed by key length, so a run can show which regimes the
# kernel served
LAUNCHES = 0
LAUNCHES_BY_KEY_LEN: collections.Counter = collections.Counter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_KEY_LEN.clear()


def _resolve_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _kernel():
    global _fn
    if _fn is None:
        from .. import kernels

        fn = kernels.load("flash_fwd").mv_flash_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        st = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, st, st, st, i, i,
                       ctypes.c_float, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def _fa_plain(q, k, v, q_base: int, k_base: int, *, causal: bool,
              scale: float, normalize: bool):
    """Full-softmax PyTorch version of the kernel on ``[B, S, H, D]``:
    the same ``-1e30`` sentinel, global offsets, guards and casts."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_base + torch.arange(Sq, device=q.device)
        k_pos = k_base + torch.arange(Sk, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1) if Sk else torch.full(s.shape[:-1], _NEG_INF,
                                             device=q.device)
    m_safe = torch.where(m <= _NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None]) * (s > _NEG_INF)
    l = p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    if normalize:
        denom = torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
        return (pv / denom).to(q.dtype), m, l
    return pv, m, l


def _fa_cuda(q, k, v, q_base: int, k_base: int, *, causal: bool,
             scale: float, normalize: bool):
    global LAUNCHES
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    if D > 128 or D % 8:
        raise ValueError(f"flash_attention: head_dim {D} must be <= 128 and "
                         f"a multiple of 8")
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: head_dim must be contiguous")
    out = torch.empty((B, Sq, H, D), device=q.device,
                      dtype=q.dtype if normalize else torch.float32)
    m = torch.empty((B, H, Sq), device=q.device, dtype=torch.float32)
    l = torch.empty((B, H, Sq), device=q.device, dtype=torch.float32)
    strides = [(ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))
               for t in (q, k, v)]
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 m.data_ptr(), l.data_ptr(), _DTYPE_CODES[q.dtype], B, H, Sq,
                 Sk, D, strides[0], strides[1], strides[2], int(causal),
                 int(normalize), scale, int(q_base), int(k_base), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_KEY_LEN[Sk] += 1
    return out, m, l


def _fa_call(q, k, v, q_base, k_base, *, causal: bool, scale: float,
             normalize: bool):
    """``[B, S, H, D]`` in; ``(out [B, Sq, H, D], m [B, H, Sq],
    l [B, H, Sq])`` out. CPU tensors take the plain version; CUDA tensors
    the kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the backward kernels are not ported yet")
    q_base, k_base = int(q_base), int(k_base)
    if q.device.type == "cpu":
        return _fa_plain(q, k, v, q_base, k_base, causal=causal, scale=scale,
                         normalize=normalize)
    if q.device.type == "cuda":
        return _fa_cuda(q, k, v, q_base, k_base, causal=causal, scale=scale,
                        normalize=normalize)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def _batched(fn):
    def run(q, k, v, *args, **kwargs):
        if q.dim() == 4:
            return fn(q, k, v, *args, **kwargs)
        if q.dim() != 3:
            raise ValueError(f"flash_attention: q must be [s, h, d] or "
                             f"[b, s, h, d], got {tuple(q.shape)}")
        res = fn(q[None], k[None], v[None], *args, **kwargs)
        return tuple(x[0] for x in res)
    return run


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention; ``q/k/v: [(batch,) seq, heads, head_dim]``, the
    output in q's dtype and shape."""
    s = _resolve_scale(q, scale)
    return _batched(lambda q, k, v: _fa_call(
        q, k, v, 0, 0, causal=causal, scale=s, normalize=True))(q, k, v)[0]


def flash_attention_partial(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_base, k_base,
        causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalised block ``(acc [(b,) s, h, d] f32, m [(b,) h, s],
    l [(b,) h, s])``. ``q_base``/``k_base`` are the global positions of
    ``q[0]``/``k[0]``, so causal masking applies in global coordinates."""
    s = _resolve_scale(q, scale)
    return _batched(lambda q, k, v: _fa_call(
        q, k, v, q_base, k_base, causal=causal, scale=s,
        normalize=False))(q, k, v)


# The JAX package's crossover, measured on a TPU (docs/TPU_VALIDATE.json):
# its XLA reference attention wins below ~1.5k sequence there. Not yet
# measured on the card; kept as the value of attention="flash".
FLASH_CROSSOVER_SEQ = 1536


def best_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   min_flash_seq: Optional[int] = None) -> torch.Tensor:
    """Crossover dispatch: :func:`reference_attention` below the crossover
    sequence length, the kernel at or above it. The kernel exists only on
    the card, so CPU tensors always take the reference (as the JAX
    package's off-TPU answer is its XLA path)."""
    thr = FLASH_CROSSOVER_SEQ if min_flash_seq is None else int(min_flash_seq)
    if max(q.shape[-3], k.shape[-3]) < thr or q.device.type != "cuda":
        from .ring_attention import reference_attention

        return reference_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)


def merge_partials(m_a, l_a, acc_a, m_b, l_b, acc_b):
    """Combine two flash partials (the associative running-max merge);
    ``m``/``l`` are ``[(b,) h, s]`` and ``acc`` is ``[(b,) s, h, d]``."""
    m = torch.maximum(m_a, m_b)
    m_safe = torch.where(m <= _NEG_INF, torch.zeros_like(m), m)
    ca = torch.exp(m_a - m_safe) * (m_a > _NEG_INF)
    cb = torch.exp(m_b - m_safe) * (m_b > _NEG_INF)
    l = l_a * ca + l_b * cb
    acc = (acc_a * ca.transpose(-1, -2)[..., None]
           + acc_b * cb.transpose(-1, -2)[..., None])
    return m, l, acc
