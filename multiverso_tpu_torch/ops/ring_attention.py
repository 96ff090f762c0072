"""Attention oracle shared by the model and the tests.

Counterpart of ``multiverso_tpu/ops/ring_attention.py::reference_attention``
(the ``attention="reference"`` path). The ring and sequence-parallel
entry points come with the distributed paths.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

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
