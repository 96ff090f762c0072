"""Flash attention: hand-written CUDA kernels and their plain versions.

Counterpart of ``multiverso_tpu/ops/flash_attention.py``. The JAX module
runs two Pallas kernels for the forward, ``_fa_kernel_single`` (the whole
K/V in one block) and ``_fa_kernel`` (online softmax over key blocks);
here one CUDA kernel a dtype in ``csrc/flash_fwd.cu`` covers both (bf16
on the tensor cores, f32 on the CUDA cores), and :func:`_fa_plain`
beside it computes the same ``(out, m, l)`` as one full softmax in
PyTorch. Its three Pallas backward kernels (one pass when the
keys fit one 1024-key block, else a dq pass and a dk/dv pass) are
``csrc/flash_bwd.cu``, with :func:`_bwd_plain` beside them.

* :func:`flash_attention` — exact attention, O(seq) memory on the card,
  differentiable through the backward kernels (a
  ``torch.autograd.Function``, JAX's ``custom_vjp``).
* :func:`flash_attention_partial` — the un-normalised block
  ``(acc, m, l)`` with global position offsets, merged across blocks by
  :func:`merge_partials`.
* :func:`flash_attention_partial_bwd` — the backward of one such block
  from the rows' ``lse`` and ``delta``: f32 ``(dq, dk, dv)`` partials,
  ring attention's gradient building block.

Layout: ``[seq, heads, head_dim]`` as in the JAX package, with an optional
leading batch dim (which replaces JAX's ``vmap``). The kernel reads that
layout through its strides, so no transpose copy is made.

The wrapper takes the plain version for tensors on the CPU (the tests) and
the CUDA kernel for tensors on a CUDA device; there it launches the kernel
or raises, and never falls back. The JAX arguments ``block_q``,
``block_k``, ``interpret`` and ``precision`` are TPU knobs and are gone.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

_NEG_INF = -1e30

# launches of the forward kernel (the plain version is not counted), and
# the same launches keyed by key length, so a run can show which regimes
# the kernel served
LAUNCHES = 0
LAUNCHES_BY_KEY_LEN: collections.Counter = collections.Counter()
# launches of each backward kernel: the one pass, the dq and dk/dv passes
BWD_LAUNCHES: Dict[str, int] = {"fused": 0, "dq": 0, "dkv": 0}
_BWD_KINDS = {"fused": 0, "dq": 1, "dkv": 2}

# JAX's _bwd_call takes its one-pass kernel when the keys fit one block at
# its default block_k (nk == 1), and the dq + dk/dv passes otherwise
FUSED_MAX_KEY_LEN = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_bwd_fn = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_KEY_LEN.clear()
    for kind in BWD_LAUNCHES:
        BWD_LAUNCHES[kind] = 0


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


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        from .. import kernels

        fn = kernels.load("flash_bwd").mv_flash_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        st = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, st,
                       st, st, st, i, ctypes.c_float, i, i, p]
        fn.restype = i
        _bwd_fn = fn
    return _bwd_fn


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


def _async_copy_ok(t: torch.Tensor) -> bool:
    """The bf16 backward kernels load tiles with 16-byte ``cp.async``
    copies: an operand must start on 16 bytes, and its batch, seq and head
    strides must be multiples of 8 elements."""
    return t.data_ptr() % 16 == 0 and all(t.stride(i) % 8 == 0
                                          for i in range(3))


def _check_async_copy_alignment(tensors) -> None:
    """Refuses, never copies, a bf16 view the 16-byte copies cannot read.
    The forward checks too, so that a training step fails before it runs
    rather than in its backward."""
    for t in tensors:
        if not _async_copy_ok(t):
            raise ValueError(
                f"flash_attention: bf16 operands must be 16-byte aligned "
                f"with batch, seq and head strides that are multiples of 8 "
                f"elements, got data_ptr % 16 = {t.data_ptr() % 16} and "
                f"strides {tuple(t.stride())}")


def _check_cuda_inputs(q, k, v, g=None) -> None:
    """What the CUDA kernels take; raises before anything is built or
    launched. ``g`` (the backward's output gradient) is shaped like q."""
    tensors = (q, k, v) if g is None else (q, k, v, g)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError("flash_attention: q, k, v (and g) must share a dtype")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [b, s, h, d], got "
                         f"{tuple(q.shape)}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if D > 128 or D % 8:
        raise ValueError(f"flash_attention: head_dim {D} must be <= 128 and "
                         f"a multiple of 8")
    if (k.shape != (B, Sk, H, D) or v.shape != k.shape
            or (g is not None and g.shape != q.shape)):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attention: head_dim must be contiguous")
    if q.dtype == torch.bfloat16:
        _check_async_copy_alignment(tensors)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("flash_attention: the CUDA kernels take CUDA "
                         "tensors only")
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention: inputs on different devices")


def _fa_cuda(q, k, v, q_base: int, k_base: int, *, causal: bool,
             scale: float, normalize: bool):
    global LAUNCHES
    _check_cuda_inputs(q, k, v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
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
    q_base, k_base = int(q_base), int(k_base)
    if q.device.type == "cpu":
        return _fa_plain(q, k, v, q_base, k_base, causal=causal, scale=scale,
                         normalize=normalize)
    if q.device.type == "cuda":
        return _fa_cuda(q, k, v, q_base, k_base, causal=causal, scale=scale,
                        normalize=normalize)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def _bwd_plain(q, k, v, g, lse, delta, q_base: int, k_base: int, *,
               causal: bool, scale: float, kinds=("dq", "dkv")):
    """PyTorch version of the backward kernels on ``[B, S, H, D]``, with
    the Pallas kernels' masks and casts: p by a select, p rounded to g's
    dtype before ``p^T g``, ds to k's before ``ds k`` and to q's before
    ``ds^T q``. ``kinds`` picks the outputs (None where not asked)."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        q_pos = q_base + torch.arange(Sq, device=q.device)
        k_pos = k_base + torch.arange(Sk, device=q.device)
        live = k_pos[None, :] <= q_pos[:, None]
        p = torch.where(live, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = dk = dv = None
    if "dq" in kinds:
        dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                          k.float())
    if "dkv" in kinds:
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(),
                          g.float())
        dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                          q.float())
    return dq, dk, dv


def bwd_kernels(sk: int) -> Tuple[str, ...]:
    """The backward kernels that key length ``sk`` takes on the card."""
    return ("fused",) if sk <= FUSED_MAX_KEY_LEN else ("dq", "dkv")


def _launch_bwd(kind: str, q, k, v, g, lse, delta, dq, dk, dv, q_base: int,
                k_base: int, *, causal: bool, scale: float) -> None:
    """One launch of backward kernel ``kind`` into the given f32 outputs
    (``fused`` adds into dq, which must hold zeros)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    strides = [(ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))
               for t in (q, k, v, g)]
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_BWD_KINDS[kind], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 _DTYPE_CODES[q.dtype], B, H, Sq, Sk, D, *strides,
                 int(causal), scale, int(q_base), int(k_base), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd[{kind}] kernel launch failed: CUDA "
                           f"error {err}")
    BWD_LAUNCHES[kind] += 1


def _bwd_cuda(q, k, v, g, lse, delta, q_base: int, k_base: int, *,
              causal: bool, scale: float):
    _check_cuda_inputs(q, k, v, g)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be f32 "
                             f"[{B}, {H}, {Sq}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lse, delta = lse.contiguous(), delta.contiguous()
    kinds = bwd_kernels(Sk)
    f32 = dict(device=q.device, dtype=torch.float32)
    dq = (torch.zeros if "fused" in kinds else torch.empty)((B, Sq, H, D),
                                                            **f32)
    dk = torch.empty((B, Sk, H, D), **f32)
    dv = torch.empty((B, Sk, H, D), **f32)
    for kind in kinds:
        _launch_bwd(kind, q, k, v, g, lse, delta, dq, dk, dv, q_base,
                    k_base, causal=causal, scale=scale)
    return dq, dk, dv


def _bwd_call(q, k, v, g, lse, delta, q_base, k_base, *, causal: bool,
              scale: float):
    """``q``/``g`` ``[B, Sq, H, D]``, ``k``/``v`` ``[B, Sk, H, D]``,
    ``lse``/``delta`` ``[B, H, Sq]`` f32 in; f32 ``(dq, dk, dv)`` out.
    CPU tensors take the plain version; CUDA tensors the kernels."""
    q_base, k_base = int(q_base), int(k_base)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, g, lse, delta, q_base, k_base,
                          causal=causal, scale=scale)
    if q.device.type == "cuda":
        return _bwd_cuda(q, k, v, g, lse, delta, q_base, k_base,
                         causal=causal, scale=scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Exact attention with the flash backward (JAX's ``_flash_fwd`` /
    ``_flash_bwd`` pair): the forward saves ``(q, k, v, out, m, l)``; the
    backward forms the row statistics in plain PyTorch, as JAX does in
    XLA, and runs the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, m, l = _fa_call(q, k, v, 0, 0, causal=causal, scale=scale,
                             normalize=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        if g.stride(-1) != 1 or (g.dtype == torch.bfloat16
                                 and not _async_copy_ok(g)):
            # autograd's own gradient tensor: a fresh copy meets the
            # kernels' layout
            g = g.clone(memory_format=torch.contiguous_format)
        lse = m + torch.log(torch.clamp(l, min=1e-20))
        delta = torch.einsum("bshd,bshd->bhs", g.float(), out.float())
        dq, dk, dv = _bwd_call(q, k, v, g, lse, delta, 0, 0,
                               causal=ctx.causal, scale=ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention; ``q/k/v: [(batch,) seq, heads, head_dim]``, the
    output in q's dtype and shape. Differentiable: the backward runs the
    backward kernels (dq, dk, dv in the input dtypes)."""
    s = _resolve_scale(q, scale)

    def one(q, k, v):
        if _needs_grad(q, k, v):
            return (_FlashAttention.apply(q, k, v, causal, s),)
        return _fa_call(q, k, v, 0, 0, causal=causal, scale=s,
                        normalize=True)

    return _batched(one)(q, k, v)[0]


def flash_attention_partial(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_base, k_base,
        causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalised block ``(acc [(b,) s, h, d] f32, m [(b,) h, s],
    l [(b,) h, s])``. ``q_base``/``k_base`` are the global positions of
    ``q[0]``/``k[0]``, so causal masking applies in global coordinates.
    Like JAX's, it has no autograd rule: its gradient is
    :func:`flash_attention_partial_bwd`, so inputs that require grad are
    refused rather than silently detached."""
    if _needs_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention_partial is not differentiable: take its "
            "gradient with flash_attention_partial_bwd")
    s = _resolve_scale(q, scale)
    return _batched(lambda q, k, v: _fa_call(
        q, k, v, q_base, k_base, causal=causal, scale=s,
        normalize=False))(q, k, v)


def flash_attention_partial_bwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        lse: torch.Tensor, delta: torch.Tensor, q_base, k_base,
        causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of one (q block, k block) pair in global coordinates, the
    gradient twin of :func:`flash_attention_partial`. ``g`` is the
    output gradient ``[(b,) sq, h, d]``; ``lse = m + log l`` and ``delta
    = rowsum(g * out)`` ``[(b,) h, sq]`` f32 come from the merged forward
    statistics. Returns f32 ``(dq, dk, dv)`` partials, this k block's
    share of dq and this q block's of dk / dv, for the caller to sum."""
    s = _resolve_scale(q, scale)
    if q.dim() == 3:
        res = _bwd_call(q[None], k[None], v[None], g[None], lse[None],
                        delta[None], q_base, k_base, causal=causal, scale=s)
        return tuple(x[0] for x in res)
    if q.dim() != 4:
        raise ValueError(f"flash_attention_partial_bwd: q must be [s, h, d] "
                         f"or [b, s, h, d], got {tuple(q.shape)}")
    return _bwd_call(q, k, v, g, lse, delta, q_base, k_base, causal=causal,
                     scale=s)


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
