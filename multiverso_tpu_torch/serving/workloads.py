"""Inference paths behind the micro-batcher.

Counterpart of ``multiverso_tpu/serving/workloads.py``'s word2vec and LM
workloads. Each binds a live training source (a table or a model) and
exposes ``run(payloads, bucket, snap) -> results``: the batcher pads the
flushed batch up to ``bucket``, the workload runs one program on the
snapshot and slices the padding back off. A program records the distinct
signatures it was called with (the JAX jit cache's counterpart), so
``jit_cache_size()`` is one per bucket used. ``validate`` rejects a bad
payload at submit time, so it never fails its batch-mates.

The logreg and FTRL workloads come with the logreg/FTRL models.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ..log import Log
from .decode_engine import _Program
from .snapshot import DerivedCache


class EmbeddingNeighbors:
    """word2vec serving: embedding lookup + top-k nearest neighbours.

    Payload: an ``int`` word id. Reply: ``(neighbor_ids [k], scores [k])``
    by cosine similarity over the input-embedding matrix table, the query
    word itself excluded. The normalized f32 matrix is derived once per
    snapshot version; the query rows are gathered from it by the row
    gather kernel (``ops.embedding.embedding_lookup``)."""

    def __init__(self, table, k: int = 8) -> None:
        self.source = table
        self.k = int(k)
        rows = table.shape[0]
        if self.k >= rows:
            Log.fatal(f"EmbeddingNeighbors: k={k} >= vocab {rows}")

        def normalize(arr: torch.Tensor) -> torch.Tensor:
            emb = arr[:rows].float()
            norm = torch.sqrt(torch.sum(emb * emb, dim=1, keepdim=True))
            return emb / torch.clamp(norm, min=1e-12)

        k_ = self.k

        def neighbors(normed: torch.Tensor, ids: torch.Tensor):
            from ..ops.embedding import embedding_lookup

            q = embedding_lookup(normed, ids)                   # [B, D]
            sims = q @ normed.t()                               # [B, V]
            # the query word itself never ranks
            sims[torch.arange(ids.shape[0], device=ids.device),
                 ids.long()] = -float("inf")
            return torch.topk(sims, k_, dim=-1)

        self._normalize = torch.no_grad()(normalize)
        self._fn = _Program(torch.no_grad()(neighbors))
        self._derived = DerivedCache(self._normalize)

    def validate(self, payload) -> None:
        """An id out of range would gather another word's row (or NaN):
        reject it at submit time."""
        wid = int(payload)
        if not 0 <= wid < self.source.shape[0]:
            raise ValueError(f"word id {wid} outside vocab "
                             f"[0, {self.source.shape[0]})")

    def run(self, payloads: List[int], bucket: int, snap) -> List[Any]:
        normed = self._derived.get(snap)
        ids = np.zeros(bucket, np.int32)
        ids[: len(payloads)] = np.asarray(payloads, np.int32)
        scores, nbr = self._fn(normed,
                               torch.from_numpy(ids).to(normed.device))
        scores, nbr = scores.cpu().numpy(), nbr.cpu().numpy()
        return [(nbr[i], scores[i]) for i in range(len(payloads))]

    def jit_cache_size(self) -> int:
        return self._fn.cache_size()


class LMGreedyDecode:
    """LM serving: greedy continuation with a KV cache.

    Payload: a 1-D prompt id array (length in ``[1, max_prompt]``).
    Reply: ``[max_new]`` generated ids. Prompts are right-padded to the
    static ``max_prompt`` and the batch to its bucket, so each bucket is
    one :func:`models.transformer.greedy_decode` signature; per-row
    lengths keep padding out of positions, logits and the attention mask.
    Pad rows decode garbage that is sliced off. The snapshot is already a
    detached copy on the model's device, so it is served as it is."""

    def __init__(self, lm, max_prompt: int, max_new: int,
                 eos_id: "int | None" = None) -> None:
        from ..models.transformer import greedy_decode

        cfg = lm.config
        if max_prompt + max_new > cfg.max_seq:
            Log.fatal(f"LMGreedyDecode: max_prompt {max_prompt} + max_new "
                      f"{max_new} exceeds max_seq {cfg.max_seq}")
        self.source = lm
        self.max_prompt = int(max_prompt)
        self.max_new = int(max_new)
        self._device = lm.device
        self._fn = _Program(
            lambda params, toks, lens: greedy_decode(
                cfg, params, toks, lens, int(max_new), eos_id))

    def validate(self, payload) -> None:
        """A bad prompt rejects its own request, not its batch."""
        p = np.asarray(payload, np.int64).ravel()
        if not 1 <= p.shape[0] <= self.max_prompt:
            raise ValueError(f"prompt length {p.shape[0]} outside "
                             f"[1, {self.max_prompt}]")

    def run(self, payloads: List[np.ndarray], bucket: int, snap) -> List[Any]:
        host = np.zeros((bucket, self.max_prompt + 1), np.int64)
        host[:, -1] = 1                # pad rows: length 1, sliced off
        for i, p in enumerate(payloads):
            p = np.asarray(p, np.int64).ravel()
            host[i, : p.shape[0]] = p
            host[i, -1] = p.shape[0]
        dev = torch.from_numpy(host).to(self._device)
        out = self._fn(snap.value, dev[:, :-1], dev[:, -1]).cpu().numpy()
        return [out[i] for i in range(len(payloads))]

    def jit_cache_size(self) -> int:
        return self._fn.cache_size()
