"""Ring attention: exact attention with the sequence sharded over a group.

Counterpart of ``multiverso_tpu/ops/ring_attention.py:36-199``
(``_block_attn``, ``ring_attention``) and of its ``reference_attention``
(the ``attention="reference"`` path and the tests' oracle). Each process
of the group holds one sequence shard of q/k/v, rank ``r`` the rows
``[r * block, (r + 1) * block)``. Each ring step computes one block of
scores flash-style (running max and normaliser, so the full
``[seq, seq]`` scores never exist) while the K/V blocks rotate one rank
further round the ring (``parallel.collectives``: gloo, staged through
the host for CUDA tensors). After ``step`` rotations a rank holds the
block that started at rank ``(r - step) mod n``.

``impl`` keeps the JAX package's values so that a reader finds the
counterpart: ``"xla"`` is the plain block math in PyTorch
(:func:`_block_attn`, differentiable by autograd through the ring's
shifts, as JAX differentiates through ``ppermute``), and ``"pallas"``
runs each step on the Hopper kernels, the forward on
``flash_attention_partial`` (K3 when a block holds at most 1,024 keys,
else K4) merged by ``merge_partials``, and the backward as a second
ring on ``flash_attention_partial_bwd`` (K5, or K6 + K7), a
``torch.autograd.Function`` (JAX's ``custom_vjp``): ``(k, v, dk, dv)``
rotate together, so the dk/dv accumulators arrive home carrying every
q shard's share, and only the forward's ``lse`` is saved. The running
statistics are f32 whatever the input dtype; the output is cast to q's
dtype at the end.

Two departures from the JAX loop, neither changing a number: the forward
makes ``n - 1`` rotations (JAX's ``n``-th brings K/V home, where nothing
reads them), and the backward's ``n``-th rotation moves only dk/dv. Like
JAX, every (q block, k block) pair runs the kernels, a causal block that
lies wholly after the rank's rows included: the kernels give it m at
-1e30, l = 0 and zero partials, which the merge and the sums ignore.

The serving faces (JAX :200-285): :func:`_prefix_chunk_attn`, the decode
engine's own chunk-attention math on heads split out, and
:func:`ring_prefill_attention`, which runs it over a chunk's rows split
over the group. They do not reuse the running-max accumulation above:
its reduction order differs from the engine's one-softmax
``_chunk_attention``, and sequence-parallel prefill must give the
single-lane chunk's rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.collectives import (_permute, check_equal_shards,
                                    group_rank_size, permute)
from .flash_attention import (flash_attention_partial,
                              flash_attention_partial_bwd, kernel_layout,
                              merge_partials)

_NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Unsharded O(seq^2) attention over ``[..., seq, heads, head_dim]``
    (an optional leading batch dim replaces JAX's ``vmap``). Scores and
    softmax accumulate in f32 whatever the input dtype; the probabilities
    are cast to v's dtype before the PV product."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("...qhd,...khd->...hqk", q.float(),
                          k.float()) * scale
    if causal:
        seq = q.shape[-3]
        mask = torch.tril(torch.ones((seq, seq), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores,
                             torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", probs.to(v.dtype),
                        v).to(q.dtype)


def _block_attn(q, k, v, q_pos, k_pos, causal: bool, scale: float, m, l,
                acc):
    """One flash-attention block accumulation step (JAX :36-59).

    q: ``[(b,) sq, h, d]``; k/v: ``[(b,) sk, h, d]``; positions ``[sq]``,
    ``[sk]``; m/l: ``[(b,) h, sq]`` running max / normaliser; acc:
    ``[(b,) sq, h, d]``, all f32.
    """
    scores = torch.einsum("...qhd,...khd->...hqk", q.float(),
                          k.float()) * scale
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # guard fully-masked rows (m_new at the sentinel) against NaNs
    m_safe = torch.where(m_new <= _NEG_INF, torch.zeros_like(m_new), m_new)
    correction = torch.exp(m - m_safe) * (m > _NEG_INF)
    p = torch.exp(scores - m_safe[..., None]) * (scores > _NEG_INF)
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("...hqk,...khd->...qhd", p, v.float())
    acc_new = acc * correction.transpose(-1, -2)[..., None] + pv
    return m_new, l_new, acc_new


def _next_prev(group):
    rank, n = group_rank_size(group)
    return (rank + 1) % n, (rank - 1) % n


def _rotate(tensors, group):
    """One step round the ring (rank r receives rank r - 1's), one packed
    exchange that autograd follows."""
    return permute(tensors, *_next_prev(group), group)


def _send_home(dk, dv, group):
    """The backward ring's last rotation: the dk/dv accumulators move one
    rank on, to the rank their k/v block came from."""
    return _permute([dk, dv], *_next_prev(group), group)


def _fwd_ring(q, k, v, group, causal: bool, scale: float, impl: str):
    """This rank's forward ring on ``[B, block, h, d]`` shards; returns
    ``(out in q's dtype, lse [B, h, block] f32)``."""
    rank, n = group_rank_size(group)
    B, block, h, _ = q.shape
    f32 = dict(device=q.device, dtype=torch.float32)
    m = torch.full((B, h, block), _NEG_INF, **f32)
    l = torch.zeros((B, h, block), **f32)
    acc = torch.zeros(q.shape, **f32)
    q_pos = rank * block + torch.arange(block, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        if step:
            k_cur, v_cur = _rotate([k_cur, v_cur], group)
        src = (rank - step) % n
        if impl == "pallas":
            acc_b, m_b, l_b = flash_attention_partial(
                q, k_cur, v_cur, rank * block, src * block, causal=causal,
                scale=scale)
            m, l, acc = merge_partials(m, l, acc, m_b, l_b, acc_b)
        else:
            k_pos = src * block + torch.arange(block, device=q.device)
            m, l, acc = _block_attn(q, k_cur, v_cur, q_pos, k_pos, causal,
                                    scale, m, l, acc)
    l_safe = torch.clamp(l, min=1e-20)
    out = acc / l_safe.transpose(-1, -2)[..., None]
    return out.to(q.dtype), m + torch.log(l_safe)


def _bwd_ring(q, k, v, out, lse, g, group, causal: bool, scale: float):
    """The second ring (JAX :160-196): f32 ``(dq, dk, dv)`` of this
    rank's shards, cast to the inputs' dtypes."""
    rank, n = group_rank_size(group)
    block = q.shape[1]
    g = kernel_layout(g)
    delta = torch.einsum("bshd,bshd->bhs", g.float(), out.float())
    dq = torch.zeros(q.shape, device=q.device, dtype=torch.float32)
    dk = torch.zeros(k.shape, device=k.device, dtype=torch.float32)
    dv = torch.zeros_like(dk)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (rank - step) % n
        dq_p, dk_p, dv_p = flash_attention_partial_bwd(
            q, k_cur, v_cur, g, lse, delta, rank * block, src * block,
            causal=causal, scale=scale)
        dq += dq_p
        dk += dk_p
        dv += dv_p
        if step < n - 1:
            # dk/dv travel with their k/v block
            k_cur, v_cur, dk, dv = _permute([k_cur, v_cur, dk, dv],
                                            *_next_prev(group), group)
    dk, dv = _send_home(dk, dv, group)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The kernel impl with its backward ring (JAX's ``_ring_pallas``
    custom VJP); saves ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float):
        out, lse = _fwd_ring(q, k, v, group, causal, scale, "pallas")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return _bwd_ring(q, k, v, out, lse, g, ctx.group, ctx.causal,
                         ctx.scale) + (None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = False,
                   scale: Optional[float] = None,
                   impl: str = "xla") -> torch.Tensor:
    """Exact attention with the sequence sharded over ``group`` (default:
    the session's; alone, plain attention over the one shard).

    q/k/v: this rank's shard ``[(batch,) block, heads, dim]``, every rank's
    of the same length (the sequence divides over the ring's ``n`` steps).
    Returns this rank's rows of the output, q's shape and dtype.
    ``impl="xla"``: the plain block math; ``impl="pallas"``: the Hopper
    kernels, forward and backward (module docstring). Every rank calls it
    (and its backward) together.
    """
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if q.dim() not in (3, 4):
        raise ValueError(f"ring_attention: q must be [s, h, d] or "
                         f"[b, s, h, d], got {tuple(q.shape)}")
    check_equal_shards(q.shape[-3], group, "ring steps")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    batched = q.dim() == 4
    if not batched:
        q, k, v = q[None], k[None], v[None]
    if impl == "xla":
        out = _fwd_ring(q, k, v, group, causal, scale, "xla")[0]
    else:
        out = _RingFlash.apply(q, k, v, group, causal, scale)
    return out if batched else out[0]


def _prefix_chunk_attn(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                       rows: torch.Tensor, dh: int) -> torch.Tensor:
    """The engine's chunk attention on split heads: ``qh`` [C, H, dh]
    against ``kh``/``vh`` [T, H, dh], row ``c`` attending positions ``<=
    rows[c]``. ``models.transformer._verify_attention`` expression for
    expression (one window: f32 scores, one softmax a row over the whole
    ``T``, one P @ V), so a slice of rows or heads computes that slice of
    the single-lane chunk. Returns [C, H, dh] in v's dtype."""
    T = kh.shape[0]
    scores = torch.einsum("skhd,sthd->shkt", qh[None].float(),
                          kh[None].float()) / math.sqrt(dh)
    mask = (torch.arange(T, device=qh.device)[None, None, :]
            <= rows[None, :, None])[:, None, :, :]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("shkt,sthd->skhd", probs.to(vh.dtype), vh[None])[0]


def ring_prefill_attention(q: torch.Tensor, kc: torch.Tensor,
                           vc: torch.Tensor, n_heads: int, offset,
                           group=None) -> torch.Tensor:
    """Serving chunk attention with the chunk's rows split over ``group``
    (default: the session's): JAX's contract, seen from one rank.

    ``q`` [C / n, D]: this rank's consecutive chunk rows (rank r holds
    rows ``[r C / n, (r + 1) C / n)``); ``kc``/``vc`` [T / n, D]: this
    rank's sequence shard of the slot's gathered view; ``offset`` the
    chunk's first cache position (a 0-d tensor or an int). ``n - 1``
    rotations (``collectives._permute``, K and V in one exchange) give
    every rank every shard, reassembled in global order, then the rank
    runs :func:`_prefix_chunk_attn` on its rows over the whole ``T``.
    Returns [C / n, D] in q's dtype. Every rank calls it together."""
    rank, n = group_rank_size(group)
    c, D = q.shape
    dh = D // n_heads
    k_parts, v_parts = [kc], [vc]
    k_cur, v_cur = kc, vc
    for _ in range(n - 1):
        k_cur, v_cur = _permute([k_cur, v_cur], *_next_prev(group), group)
        k_parts.append(k_cur)
        v_parts.append(v_cur)
    # after j rotations a rank holds the shard of rank (rank - j) mod n
    order = [(rank - s) % n for s in range(n)]
    k_full = torch.cat([k_parts[j] for j in order])
    v_full = torch.cat([v_parts[j] for j in order])
    T = k_full.shape[0]
    rows = offset + rank * c + torch.arange(c, device=q.device)
    out = _prefix_chunk_attn(q.reshape(c, n_heads, dh),
                             k_full.reshape(T, n_heads, dh),
                             v_full.reshape(T, n_heads, dh), rows, dh)
    return out.reshape(c, D).to(q.dtype)
