"""Ulysses-style all-to-all sequence parallelism (head-resharded attention).

Counterpart of ``multiverso_tpu/ops/ulysses.py:39-102``. The second
long-context scheme beside ring attention (``ops/ring_attention.py``):
instead of rotating K/V blocks round the ring, two all-to-alls reshard
the activations from sequence-sharded to head-sharded and back
(DeepSpeed-Ulysses, Jacobs et al., 2023):

  1. each process holds q/k/v ``[(b,) seq/n, H, d]``, its sequence shard;
  2. :func:`~..parallel.collectives.all_to_all` (split heads, concatenate
     sequence) gives each process the WHOLE sequence for ``H/n`` heads;
  3. exact attention runs locally on those heads, with no collective;
  4. the reverse all-to-all restores sequence sharding over all heads.

Two exchanges a call instead of the ring's ``n - 1`` rotations, at the
price of ``H % n == 0``. Differentiable: the backward of each all-to-all
is the reverse all-to-all, and the local attention is autograd's
(``impl="xla"``) or the flash backward kernels' (``impl="flash"``).

:func:`ulysses_prefill_attention` is the serving face (JAX :105): the
decode engine's chunk attention with the chunk's rows split over the
group and K/V split by heads, the paged pool's own layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.collectives import (all_to_all, check_equal_shards,
                                    group_rank_size)
from .ring_attention import _prefix_chunk_attn, reference_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, causal: bool = False,
                      scale: Optional[float] = None, impl: str = "xla",
                      **attn_kwargs) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``group`` (default:
    the session's) via all-to-all.

    q/k/v: this rank's shard ``[(batch,) block, heads, dim]``, every
    rank's of the same length; ``heads`` must divide by the group size.
    Returns this rank's rows of the output, q's shape and dtype.
    ``impl="xla"`` attends locally with :func:`reference_attention`;
    ``impl="flash"`` with the crossover dispatch
    (:func:`~.flash_attention.best_attention`: the flash kernels forward
    and backward on the card at or above the crossover length), and
    ``attn_kwargs`` (``min_flash_seq``) pass through to it.
    """
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown ulysses impl {impl!r}")
    if impl == "xla" and attn_kwargs:
        raise ValueError("attn_kwargs only apply to impl='flash'")
    _, n = group_rank_size(group)
    heads = int(q.shape[-2])
    if heads % n != 0:
        raise ValueError(
            f"ulysses needs heads ({heads}) divisible by the group size "
            f"{n}; use ring_attention for fewer heads")
    check_equal_shards(q.shape[-3], group, "shards")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if impl == "flash":
        from .flash_attention import best_attention as local_attn
    else:
        local_attn = reference_attention

    def to_heads(x):
        # [(b,) seq/n, H, d] -> [(b,) seq, H/n, d]
        return all_to_all(x, -2, -3, group)

    out = local_attn(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                     scale=scale, **attn_kwargs)
    # [(b,) seq, H/n, d] -> [(b,) seq/n, H, d]
    return all_to_all(out, -3, -2, group).to(q.dtype)


def ulysses_prefill_attention(q: torch.Tensor, kc: torch.Tensor,
                              vc: torch.Tensor, n_heads: int, offset,
                              group=None) -> torch.Tensor:
    """Serving chunk attention with the chunk's rows split over ``group``
    (default: the session's), resharded by heads: JAX's contract, seen
    from one rank.

    ``q`` [C / n, D]: this rank's consecutive chunk rows; ``kc``/``vc``
    [T, D / n]: the slot's gathered view, this rank's ``H / n`` whole
    heads (the pool's head slice, so the prefix never moves); ``offset``
    the chunk's first cache position. One ``all_to_all`` turns the row
    shard of q into a head shard (every row, this rank's heads), the rank
    runs the engine's chunk math (``ring_attention._prefix_chunk_attn``)
    on its heads over the whole ``T``, and the reverse ``all_to_all``
    gives back its rows. Returns [C / n, D] in q's dtype. Needs ``n_heads
    % n == 0``; every rank calls it together."""
    _, n = group_rank_size(group)
    if n_heads % n != 0:
        raise ValueError(
            f"ulysses needs heads ({n_heads}) divisible by the group size "
            f"{n}; use ring_prefill_attention for fewer heads")
    D = q.shape[1]
    T = kc.shape[0]
    hl, dh = n_heads // n, D // n_heads
    qf = all_to_all(q, 1, 0, group)                  # [C, D / n]
    C = qf.shape[0]
    rows = offset + torch.arange(C, device=q.device)
    out = _prefix_chunk_attn(qf.reshape(C, hl, dh), kc.reshape(T, hl, dh),
                             vc.reshape(T, hl, dh), rows, dh)
    return all_to_all(out.reshape(C, D // n), 0, 1, group).to(q.dtype)
