"""Word2vec (skip-gram / CBOW, negative sampling / hierarchical softmax),
trained on the card.

Counterpart of ``multiverso_tpu/models/word2vec.py`` (the reference
WordEmbedding model core, ``Applications/WordEmbedding/src/
wordembedding.cpp``). One step trains a whole batch of examples against
the two embedding tables: gather the rows, closed-form sigmoid-loss
gradients with f32 scores, scatter-add the row updates. Every
embedding-row gather is ``ops.embedding.embedding_lookup`` and every row
update ``ops.embedding.scatter_add_rows``, so on the card the step runs
the hand-written row-gather and row-scatter-add kernels: the skip-gram
centers, the CBOW context windows ``[B, 2W]``, the Huffman path nodes
``[B, L]`` of hierarchical softmax and AdaGrad's f32 accumulator rows
alike.

What differs from the JAX module, and why:

* the tables (and AdaGrad's accumulators) are updated IN PLACE (the JAX
  step threads donated buffers through a jitted function); every gather of
  a step still reads the tables before any update of that step, as in JAX;
* ``lax.scan`` over the ``steps_per_call`` batches is a Python loop;
* randomness is a ``torch.Generator`` (threefry and torch never agree), and
  the corpus step takes its random draws as an argument
  (``train_device_steps(..., draws=)``), so a test can feed both packages
  the same draws;
* nothing in a dispatch waits for the device: the counts, the compaction
  size and the loss stay device tensors; ``train_device_steps`` returns
  ``(loss, count)`` as device scalars, like JAX's async scalars;
* ``update_impl`` ``segsum`` and ``split8`` are PyTorch ops (``index_add_``
  into an f32 buffer kept between steps), as they are XLA ops in JAX.

Ported: every single-process option of the JAX config: skip-gram and
CBOW, negative sampling (the exact alias draw or the pre-drawn pool, every
group size G) and hierarchical softmax, alone or together, plain SGD and
AdaGrad, raw summed updates and both row-mean stabilisers (realized counts
and ``row_mean_static``), ``update_impl`` ``scatter``/``segsum``/
``split8``, ``compact_impl`` ``scatter``/``gather``, the device-resident
corpus path and the host-batch entry points (``train_batch``,
``train_batches``). Refused with :class:`~..log.FatalError`: an unknown
``update_impl`` (the JAX step takes any other value for ``scatter``) or
``compact_impl``. Worker-axis data parallelism (``dp_sync``,
``dp_exchange`` over the table mesh's worker axis) is not ported yet
(ROADMAP.md Queue 1 item 8h): the model trains as on a worker axis of 1
whatever the table's mesh, where the JAX package ignores both options
too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..log import Log
from ..ops.embedding import _wrapped, embedding_lookup, scatter_add_rows

_ADAGRAD_EPS = 1e-8
_UPDATE_IMPLS = ("scatter", "segsum", "split8")
_SPLIT_LANES = 8     # split8's shadow copies


@dataclass
class Word2VecConfig:
    """The JAX config's fields, with the same defaults (reference CLI
    options, ``WE/src/util.cpp``). See ``multiverso_tpu/models/word2vec.py``
    for the meaning of each; values this port does not run raise in
    :class:`Word2Vec`."""

    vocab_size: int = 0
    embedding_size: int = 100
    window: int = 5
    negative: int = 5
    hs: bool = False
    cbow: bool = False
    init_lr: float = 0.025
    min_lr_frac: float = 1e-4
    use_adagrad: bool = False
    batch_size: int = 1024
    steps_per_call: int = 1
    max_code_length: int = 40
    seed: int = 7
    oversample: float = 0.0
    neg_pool_size: int = 0
    shared_negatives: int = 0
    row_mean_updates: Optional[bool] = None
    update_impl: str = "scatter"
    compact_impl: str = "scatter"
    row_mean_static: bool = False
    row_update_cap: float = 8.0
    dp_sync: str = "dispatch"
    dp_exchange: str = "dense"
    dp_keyed_cap: int = 0


def build_unigram_alias(counts: np.ndarray, power: float = 0.75
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Alias tables for O(1) unigram^0.75 negative sampling (a copy of the
    JAX package's numpy helper: the same tables, bit for bit)."""
    probs = counts.astype(np.float64) ** power
    probs /= probs.sum()
    n = probs.shape[0]
    scaled = probs * n
    alias = np.zeros(n, np.int32)
    thresh = np.ones(n, np.float32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        thresh[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        thresh[i] = 1.0
        alias[i] = i
    return thresh, alias


def pack_alias_table(thresh: Any, alias: Any) -> torch.Tensor:
    """``[V, 2]`` int32: the threshold's float32 bits beside the alias."""
    t = torch.as_tensor(np.asarray(thresh, np.float32)).view(torch.int32)
    a = torch.as_tensor(np.asarray(alias, np.int32))
    return torch.stack([t, a], dim=1)


def sample_negatives(gen: torch.Generator, packed: torch.Tensor,
                     shape: Tuple[int, ...]) -> torch.Tensor:
    """Draw int32 indices from a packed alias table, on its device."""
    n = packed.shape[0]
    idx = torch.randint(0, n, shape, generator=gen, device=packed.device)
    u = torch.rand(shape, generator=gen, device=packed.device)
    row = packed[idx]                                        # [..., 2]
    t = row[..., 0].contiguous().view(torch.float32)
    return torch.where(u < t, idx.to(torch.int32), row[..., 1])


def build_negative_pool(thresh: np.ndarray, alias: np.ndarray, size: int,
                        seed: int = 0) -> np.ndarray:
    """Pre-draw ``size`` unigram^0.75 samples on the host (a copy of the
    JAX package's numpy helper: the same pool, bit for bit)."""
    rng = np.random.default_rng(seed)
    n = thresh.shape[0]
    idx = rng.integers(0, n, size).astype(np.int32)
    u = rng.random(size).astype(np.float32)
    return np.where(u < thresh[idx], idx, alias[idx]).astype(np.int32)


def pool_negatives(gen: torch.Generator, pool: torch.Tensor,
                   shape: Tuple[int, ...]) -> torch.Tensor:
    """``prod(shape)`` consecutive pool entries at a random offset. The
    offset stays on the device (no host sync): the slice is an index
    gather of the pool."""
    n = int(np.prod(shape))
    start = torch.randint(0, pool.shape[0] - n + 1, (1,), generator=gen,
                          device=pool.device)
    idx = start + torch.arange(n, device=pool.device)
    return pool[idx].reshape(shape)


def _at(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` (``jnp.take``); an id past the table, whose update
    is dropped, reads the last row."""
    return table.index_select(
        0, torch.clamp(rows.reshape(-1), max=table.shape[0] - 1))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def _f32(x: float) -> float:
    """A Python float holding a float32 value (JAX's lr is a float32)."""
    return float(np.float32(x))


def tables_from_jax(w_in: Any, w_out: Any, device: Any = None,
                    dtype: Any = torch.float32):
    """The JAX word2vec tables (their ``get()`` arrays) as the port's two
    ``MatrixTable``s on ``device`` (default: the session's) in ``dtype``,
    so both packages train from the same state. The word2vec counterpart
    of ``transformer.params_from_jax``; needs a started session."""
    from ..tables import MatrixTable

    def table(a):
        a = np.asarray(a, np.float32)
        return MatrixTable(a.shape[0], a.shape[1], dtype=dtype,
                           init_value=a, device=device)

    return table(w_in), table(w_out)


class Word2Vec:
    """Trainer bound to input/output embedding tables (``MatrixTable``)."""

    def __init__(self, config: Word2VecConfig, input_table, output_table,
                 counts: Optional[np.ndarray] = None,
                 huffman: Any = None) -> None:
        if config.vocab_size <= 0:
            config.vocab_size = input_table.num_row
        self.config = config
        self.input_table = input_table
        self.output_table = output_table
        self.device = input_table.device
        if config.negative <= 0 and not config.hs:
            Log.fatal("word2vec needs an output objective: negative > 0 "
                      "and/or hs=True")
        if (config.shared_negatives > 1
                and config.batch_size % config.shared_negatives != 0):
            Log.fatal("batch_size must divide by shared_negatives group")
        _refuse_unknown(config)
        self._host_counts = (None if counts is None
                             else np.asarray(counts, np.float64))
        if config.row_mean_updates and config.row_mean_static:
            # static scales model full, compacted skip-gram batches only
            if counts is None:
                Log.fatal("row_mean_static requires vocab counts")
            if config.use_adagrad:
                Log.fatal("row_mean_static supports plain SGD only")
            if config.hs:
                # HS scatters Huffman NODE ids: the word-law table would
                # leave the hottest rows (top tree nodes) uncapped
                Log.fatal("row_mean_static does not support hierarchical "
                          "softmax (use realized counts)")
            if config.cbow:
                Log.fatal("row_mean_static supports skip-gram only")
            if config.oversample <= 1:
                Log.fatal("row_mean_static requires oversample > 1 "
                          "(compacted full batches make the expected "
                          "counts match realizations)")
        self._packed_alias: Optional[torch.Tensor] = None
        if config.negative > 0:
            if counts is None:
                Log.fatal("negative sampling requires vocab counts")
            thresh, alias = build_unigram_alias(self._host_counts)
            self._packed_alias = pack_alias_table(thresh, alias).to(
                self.device)
            self._host_thresh, self._host_alias = thresh, alias
        if config.hs:
            if huffman is None:
                Log.fatal("hierarchical softmax requires huffman codes")
            # [V, L] lookups by target word: small tables, index_select
            # (jnp.take in JAX), not the float row-gather kernel
            self._paths = torch.as_tensor(
                np.asarray(huffman.paths, np.int32)).to(self.device)
            self._codes = torch.as_tensor(
                np.asarray(huffman.codes, np.float32)).to(self.device)
            self._path_mask = torch.as_tensor(
                np.asarray(huffman.mask, np.float32)).to(self.device)
        if config.use_adagrad:
            # the accumulators are f32 tables shaped like the embeddings
            self._g_in = torch.zeros(tuple(input_table._data.shape),
                                     dtype=torch.float32, device=self.device)
            self._g_out = torch.zeros(tuple(output_table._data.shape),
                                      dtype=torch.float32,
                                      device=self.device)
        # segsum / split8's f32 buffer, allocated once and zeroed per use
        self._dense_buf: Optional[torch.Tensor] = None
        self._neg_pool: Optional[torch.Tensor] = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(config.seed))
        # window offset of each shifted-copy index 0..2W-1, built once: a
        # copy from the host inside a step would wait for the stream
        W = config.window
        self._ctx_offsets = torch.tensor(
            list(range(-W, 0)) + list(range(1, W + 1)), device=self.device)
        self._static_scale_in: Optional[torch.Tensor] = None
        self._static_scale_out: Optional[torch.Tensor] = None
        self._words_trained = 0.0  # corpus WORDS (not pairs), see current_lr
        self.total_words = 0       # set by the trainer for lr decay
        # device-corpus stream cursor; persists across chunk loads
        self._stream_pos = 0

    # -- lr schedule (reference UpdateLearningRate, wordembedding.cpp:38) --
    def current_lr(self) -> float:
        """Linear decay over corpus words, floored at ``min_lr_frac``."""
        cfg = self.config
        if cfg.use_adagrad or self.total_words <= 0:
            return cfg.init_lr
        frac = 1.0 - self._words_trained / (self.total_words + 1)
        return cfg.init_lr * max(frac, cfg.min_lr_frac)

    def set_words_trained(self, words: float) -> None:
        """Exact progress hook for trainers that track corpus words."""
        self._words_trained = float(words)

    def set_stream_pos(self, pos: int) -> None:
        """Place the device-corpus stream cursor."""
        self._stream_pos = int(pos)

    def _pairs_to_words(self, pairs: float) -> float:
        return pairs / (self.config.window + 1)

    def _batch_words(self, mask: np.ndarray) -> float:
        """Word-unit progress for a host batch (see ``current_lr``)."""
        if self.config.cbow:
            # one CBOW example == one center-word occurrence
            return float((mask.sum(axis=-1) > 0).sum())
        return self._pairs_to_words(float(mask.sum()))

    # -- one step ------------------------------------------------------------
    def _objective_grads(self, hf, w_out, target_word, ex_mask, negs=None):
        """The output-side objectives on f32 hidden vectors ``hf`` ``[B,
        D]``: negative sampling (one implementation for exact, G = 1, and
        group-shared, G > 1, draws) and hierarchical softmax, added when
        both are on, as the reference trainer runs both branches. Returns
        the mean loss, the f32 grad wrt ``hf`` and the ``(rows, grads,
        occurrence)`` scatter sets for ``w_out`` in JAX's order (positive,
        negatives, HS nodes). Rows are gathered straight into f32 (the
        kernel widens bf16)."""
        cfg = self.config
        G = max(int(cfg.shared_negatives), 1)
        K = cfg.negative
        B, D = hf.shape
        f32 = torch.float32
        loss = 0.0
        grad_h = None
        scatters = []
        if K > 0:
            if negs is None:
                negs = sample_negatives(self._gen, self._packed_alias,
                                        (B // G, K))
            # positive pairs (always exact, per pair); f32 scores
            u_pos = embedding_lookup(w_out, target_word, out_dtype=f32)
            s_pos = torch.clamp((hf * u_pos).sum(-1), -30.0, 30.0)
            g_pos = (torch.sigmoid(s_pos) - 1.0) * ex_mask
            loss = ((_softplus(s_pos) - s_pos) * ex_mask).sum()
            grad_h = g_pos[:, None] * u_pos
            # scatter grads in the TABLE dtype when that rounds the same as
            # the scatter's own cast (JAX's exact_cast): plain SGD raw sums,
            # G = 1
            exact_cast = (not cfg.use_adagrad and G == 1
                          and not cfg.row_mean_updates)
            scat_dt = w_out.dtype if exact_cast else f32
            scatters.append((target_word, (g_pos[:, None] * hf).to(scat_dt),
                             ex_mask))
            # negatives: [B/G, K, D] rows shared by each group of G pairs
            u_neg = embedding_lookup(w_out, negs, out_dtype=f32)
            hg = hf.reshape(B // G, G, D)
            mg = ex_mask.reshape(B // G, G)
            s_neg = torch.clamp(torch.einsum("gbd,gkd->gbk", hg, u_neg),
                                -30.0, 30.0)
            g_neg = torch.sigmoid(s_neg) * mg[:, :, None]
            loss = loss + (_softplus(s_neg) * mg[:, :, None]).sum()
            grad_h = grad_h + torch.einsum("gbk,gkd->gbd", g_neg,
                                           u_neg).reshape(B, D)
            # a negative slot's grad sums its group's valid pairs, so its
            # occurrence weight is the valid-pair count
            occ_neg = mg.sum(dim=1)[:, None].expand(B // G, K).reshape(-1)
            scatters.append((negs.reshape(-1),
                             torch.einsum("gbk,gbd->gkd", g_neg,
                                          hg).to(scat_dt).reshape(-1, D),
                             occ_neg))
        if cfg.hs:
            # the target's Huffman path: [B, L] inner nodes, their code
            # bits and the valid-step mask; node rows through the kernel
            tw = target_word.reshape(-1)
            nodes = self._paths.index_select(0, tw)
            labels = 1.0 - self._codes.index_select(0, tw)
            pmask = self._path_mask.index_select(0, tw)
            u = embedding_lookup(w_out, nodes, out_dtype=f32)   # [B, L, D]
            scores = torch.clamp(torch.einsum("bd,bld->bl", hf, u),
                                 -30.0, 30.0)
            g = (torch.sigmoid(scores) - labels) * pmask * ex_mask[:, None]
            path_loss = (_softplus(scores) - labels * scores) * pmask
            loss = loss + (path_loss.sum(1) * ex_mask).sum()
            g_hs = torch.einsum("bl,bld->bd", g, u)
            grad_h = g_hs if grad_h is None else grad_h + g_hs
            # HS grads stay f32 (no exact_cast). The slots that carry no
            # gradient (path pads, masked examples) scatter to an id out
            # of range, which every update drops: JAX adds their zero
            # rows to node 0, the same table after a chain of up to B * L
            # adds on one row
            occ = (pmask * ex_mask[:, None]).reshape(-1)
            rows = torch.where(occ > 0, nodes.reshape(-1),
                               torch.full_like(occ, w_out.shape[0],
                                               dtype=nodes.dtype))
            scatters.append((rows,
                             (g[:, :, None] * hf[:, None, :]).reshape(-1, D),
                             occ))
        loss = loss / torch.clamp(ex_mask.sum(), min=1.0)
        return loss, grad_h, scatters

    def _row_counts(self, sets) -> torch.Tensor:
        """Per-row contribution counts summed over ALL scatter sets of one
        table (one joint count keeps the cap a per-table bound)."""
        V = self.config.vocab_size
        counts = torch.zeros((V,), dtype=torch.float32, device=self.device)
        for rows, occ in sets:
            w, ok = _wrapped(rows, V)
            counts.index_add_(0, torch.where(ok, w, torch.zeros_like(w)),
                              occ.reshape(-1) * ok)
        return counts

    def _row_scale_table(self, counts: torch.Tensor) -> torch.Tensor:
        """``[V]`` multiplier ``min(count, cap) / count`` of every row, the
        scatter kernel's ``row_scale``."""
        cap = max(float(self.config.row_update_cap), 1.0)
        c = torch.clamp(counts, min=1.0)
        return torch.clamp(c, max=cap) / c

    def _apply_updates(self, w_in, w_out, in_rows, in_grads, in_occ,
                       scatters, lr: float) -> None:
        """Apply one step's updates in place, in the JAX step's order: the
        input table's set, then the output table's sets. Plain SGD is
        ``w[rows] += -lr * scale[rows] * grads`` with ``scale`` a ``[V]``
        table (the row-mean stabilisers) or none; AdaGrad first scales the
        grads by the realized row-mean scale, then runs :meth:`_adagrad`
        set by set."""
        cfg = self.config
        in_scale = out_scale = None
        if cfg.row_mean_updates and cfg.row_mean_static:
            if self._static_scale_in is None:
                Log.fatal("row_mean_static needs the expected-count tables "
                          "from load_corpus_chunk (device-corpus path)")
            in_scale = self._static_scale_in
            out_scale = self._static_scale_out
        elif cfg.row_mean_updates:
            in_scale = self._row_scale_table(
                self._row_counts([(in_rows, in_occ)]))
            out_scale = self._row_scale_table(self._row_counts(
                [(rows, occ) for rows, _, occ in scatters]))
        if cfg.use_adagrad:
            # AdaGrad takes the scaled grads twice (accumulator and
            # update): scaled once and materialized, as in JAX
            def scaled(scale, rows, grads):
                if scale is None:
                    return grads
                return grads * _at(scale, rows)[:, None]

            self._adagrad(w_in, self._g_in, in_rows,
                          scaled(in_scale, in_rows, in_grads), lr)
            for rows, grads, _ in scatters:
                self._adagrad(w_out, self._g_out, rows,
                              scaled(out_scale, rows, grads), lr)
        elif cfg.update_impl == "scatter":
            # the products in f32, and the rounding to the table dtype, in
            # the scatter kernel
            scatter_add_rows(w_in, in_rows, in_grads, alpha=-lr,
                             row_scale=in_scale)
            for rows, grads, _ in scatters:
                scatter_add_rows(w_out, rows, grads, alpha=-lr,
                                 row_scale=out_scale)
        else:
            self._apply_dense(w_in, in_rows, in_grads, lr, in_scale)
            # the dense impls pay a whole-table pass each: one for all the
            # output table's sets
            self._apply_dense(
                w_out, torch.cat([r.reshape(-1) for r, _, _ in scatters]),
                torch.cat([g.float() for _, g, _ in scatters]), lr,
                out_scale)

    def _adagrad(self, w, g_acc, rows, grads, lr: float) -> None:
        """``apply_adagrad``: ``g_rows`` is each row's accumulator BEFORE
        this set plus the pair's own ``grad**2`` (duplicates in a set do
        not see each other), the accumulator takes every ``grad**2``, and
        ``w[rows] += -(lr / sqrt(g_rows + eps)) * grads``, rounded to the
        table dtype. Both tables' rows go through the kernels: the f32
        accumulator's gather and its unscaled f32 scatter-add too."""
        rows = rows.reshape(-1)
        sq = grads * grads
        # an id past the table (an HS pad slot, whose update is dropped)
        # reads the last row, as in _at, not the gather's NaN row
        g_rows = embedding_lookup(
            g_acc, torch.clamp(rows, max=g_acc.shape[0] - 1)) + sq
        scatter_add_rows(g_acc, rows, sq)
        # lr / x as one division (a Python number over a tensor would be
        # lr * (1 / x), another rounding)
        scale = torch.full_like(g_rows, lr).div_(
            torch.sqrt(g_rows + _ADAGRAD_EPS))
        scatter_add_rows(w, rows, -scale * grads)

    def _apply_dense(self, w, rows, grads, lr: float, scale) -> None:
        """``update_impl`` ``segsum`` (every row's f32 updates summed into
        a dense ``[V, D]`` buffer by one ``index_add_``) or ``split8``
        (into 8 shadow copies by update position % 8, then summed), then
        ``w = (w + dense)`` in f32, rounded once to the table dtype. An id
        past the table is dropped, as ``segment_sum`` drops it."""
        V = w.shape[0]
        rows = rows.reshape(-1).long()
        coef = -lr if scale is None else (_at(scale, rows) * -lr)[:, None]
        keep = rows < V
        upd = torch.where(keep[:, None], coef * grads.float(), 0.0)
        rows = torch.where(keep, rows, 0)
        lanes = _SPLIT_LANES if self.config.update_impl == "split8" else 1
        shape = (lanes * V,) + tuple(w.shape[1:])
        if self._dense_buf is None or tuple(self._dense_buf.shape) != shape:
            self._dense_buf = torch.empty(shape, dtype=torch.float32,
                                          device=w.device)
        dense = self._dense_buf.zero_()
        if lanes > 1:
            lane = torch.arange(rows.shape[0], device=rows.device) % lanes
            rows = lane * V + rows
        dense.index_add_(0, rows, upd)
        if lanes > 1:
            dense = dense.view((lanes,) + tuple(w.shape)).sum(0)
        w.copy_((w.float() + dense).to(w.dtype))

    def _raw_step(self, w_in, w_out, centers, contexts, mask, lr: float,
                  negs=None) -> torch.Tensor:
        """One batch on table tensors, updated in place; returns the mean
        loss (a device scalar). Skip-gram: ``centers``, ``contexts``,
        ``mask`` ``[B]``. CBOW: ``centers [B]`` (the targets), ``contexts``
        and ``mask`` ``[B, 2W]`` (per-slot validity). ``negs`` ``[B/G,
        K]`` int32, drawn from the model's generator when None."""
        f32 = torch.float32
        if not self.config.cbow:
            h = embedding_lookup(w_in, centers, out_dtype=f32)
            loss, grad_h, scatters = self._objective_grads(
                h, w_out, contexts, mask, negs)
            self._apply_updates(w_in, w_out, centers, grad_h, mask,
                                scatters, lr)
            return loss
        # CBOW: the input is the mean of the context rows; the target is
        # the center word
        rows = embedding_lookup(w_in, contexts, out_dtype=f32)  # [B, C, D]
        counts = torch.clamp(mask.sum(dim=1), min=1.0)
        h = torch.einsum("bcd,bc->bd", rows, mask) / counts[:, None]
        ex_mask = (mask.sum(dim=1) > 0).to(f32)
        loss, grad_h, scatters = self._objective_grads(h, w_out, centers,
                                                       ex_mask, negs)
        # d h / d row_c = cmask_c / count
        in_grads = grad_h[:, None, :] * (mask / counts[:, None])[:, :, None]
        # the masked slots carry no gradient: they scatter to an id out of
        # range, which every update drops (JAX adds their zero rows, the
        # same table after a chain of ~56,000 adds a step on the head word)
        in_rows = torch.where(mask > 0, contexts,
                              torch.full_like(contexts, w_in.shape[0]))
        self._apply_updates(w_in, w_out, in_rows.reshape(-1),
                            in_grads.reshape(-1, h.shape[1]),
                            mask.reshape(-1), scatters, lr)
        return loss

    # -- host-batch entry points ---------------------------------------------
    def _dispatch(self, centers, contexts, mask, stacked: bool
                  ) -> torch.Tensor:
        lr = _f32(self.current_lr())
        mask = np.asarray(mask, np.float32)
        c = self._upload(centers, np.int32)
        t = self._upload(contexts, np.int32)
        m = self._upload(mask, np.float32)
        # CBOW: contexts and mask carry the 2W window slots
        want = tuple(c.shape) + ((2 * self.config.window,)
                                 if self.config.cbow else ())
        if c.dim() != (2 if stacked else 1) or tuple(t.shape) != want \
                or tuple(m.shape) != want:
            slots = ", 2W" if self.config.cbow else ""
            Log.fatal(f"batch shapes centers {tuple(c.shape)} contexts "
                      f"{tuple(t.shape)} mask {tuple(m.shape)} (want "
                      f"[{'S, ' if stacked else ''}B] centers, contexts and "
                      f"mask [{'S, ' if stacked else ''}B{slots}])")
        with self.input_table._lock, self.output_table._lock:
            w_in, w_out = self.input_table._data, self.output_table._data
            if stacked:
                loss = torch.stack([self._raw_step(w_in, w_out, c[s], t[s],
                                                   m[s], lr)
                                    for s in range(c.shape[0])]).mean()
            else:
                loss = self._raw_step(w_in, w_out, c, t, m, lr)
            self.input_table.version += 1
            self.output_table.version += 1
        self._words_trained += self._batch_words(mask)
        return loss

    def _upload(self, a: Any, dtype) -> torch.Tensor:
        """A host array on the model's device. To the card through pinned
        memory without waiting (the JAX ``device_put`` is asynchronous
        too), so a host-stream dispatch never blocks on the stream."""
        t = torch.as_tensor(np.asarray(a, dtype))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def train_batch(self, centers: np.ndarray, contexts: np.ndarray,
                    mask: Optional[np.ndarray] = None) -> torch.Tensor:
        """Train one batch. Skip-gram: ``centers``, ``contexts``, ``mask``
        ``[B]``; CBOW: ``centers [B]``, ``contexts`` and ``mask`` ``[B,
        2W]`` (per-slot validity). Returns the mean loss as a device scalar
        (``float()`` waits)."""
        if mask is None:
            mask = np.ones(np.shape(contexts), np.float32)
        return self._dispatch(centers, contexts, mask, stacked=False)

    def train_batches(self, centers: np.ndarray, contexts: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> torch.Tensor:
        """Train a stack of batches ``[S, B(, 2W)]`` in one call."""
        if mask is None:
            mask = np.ones(np.shape(contexts), np.float32)
        return self._dispatch(centers, contexts, mask, stacked=True)

    # -- device-resident corpus path (the fast path) -----------------------
    def _ensure_neg_pool(self, n_draws: int) -> torch.Tensor:
        """Device pool with at least ``2 * n_draws`` pre-drawn negatives
        (the same numpy draw as the JAX package: seed ``cfg.seed + 1``)."""
        need = max(int(self.config.neg_pool_size), 2 * n_draws)
        if self._neg_pool is None or self._neg_pool.shape[0] < 2 * n_draws:
            pool = build_negative_pool(self._host_thresh, self._host_alias,
                                       need, seed=self.config.seed + 1)
            self._neg_pool = torch.from_numpy(pool).to(self.device)
        return self._neg_pool

    def _candidate_batch(self, n: int) -> int:
        """Candidate slab length M for a corpus chunk of ``n`` positions
        (clamped so the extended buffers stay in bounds)."""
        cfg = self.config
        B, W = cfg.batch_size, cfg.window
        if n < B + 2 * W:
            Log.fatal(f"corpus chunk ({n} positions) smaller than "
                      f"batch + 2*window ({B + 2 * W}); lower batch_size or "
                      "load a larger chunk")
        M = (max(B, int(round(B * cfg.oversample)))
             if cfg.oversample > 1 else B)
        return min(M, n - 2 * W)

    def load_corpus_chunk(self, ids: np.ndarray, sent_ids: np.ndarray,
                          discard: Optional[np.ndarray] = None) -> None:
        """Upload a corpus chunk to the device (word ids, sentence ids and
        the words' discard probabilities for subsampling), as the
        wrap-around-extended buffers the corpus step slices."""
        cfg = self.config
        dev = self.device
        corpus = torch.as_tensor(np.asarray(ids, np.int32)).to(dev)
        sents = torch.as_tensor(np.asarray(sent_ids, np.int32)).to(dev)
        if discard is None:
            discard = np.zeros(cfg.vocab_size, np.float32)
        disc = torch.as_tensor(np.asarray(discard, np.float32)).to(dev)
        n = int(corpus.shape[0])
        M = self._candidate_batch(n)
        W = cfg.window
        dpos = disc[corpus.long()]

        def ext(a):
            return torch.cat([a[-W:], a, a[:M + W]])

        self._ext_bufs = (ext(corpus), ext(sents), ext(dpos))
        if cfg.row_mean_updates and cfg.row_mean_static:
            self._build_static_scales(np.asarray(discard, np.float64))
        self._corpus_len = n

    def _build_static_scales(self, discard: np.ndarray) -> None:
        """Expected-count scale tables (``row_mean_static``): per step, row
        v's expected colliding grads are ``B * p_eff(v)`` for the input
        table and ``B * p_eff(v) + B * K * p_neg(v)`` for the output table
        (``p_eff`` the subsampled unigram law, ``p_neg`` unigram^0.75);
        scale = min(E, cap) / max(E, 1)."""
        cfg = self.config
        counts = np.asarray(self._host_counts, np.float64)
        keep = np.clip(1.0 - discard, 0.0, 1.0)
        eff = counts * keep
        p_eff = eff / max(eff.sum(), 1e-12)
        w75 = counts ** 0.75
        p_neg = w75 / max(w75.sum(), 1e-12)
        B, K = cfg.batch_size, cfg.negative
        e_in = B * p_eff
        e_out = B * p_eff + B * K * p_neg

        def scale(e):
            c = np.maximum(e, 1.0)
            s = np.minimum(c, max(float(cfg.row_update_cap), 1.0)) / c
            return torch.from_numpy(s.astype(np.float32)).to(self.device)

        self._static_scale_in, self._static_scale_out = scale(e_in), \
            scale(e_out)

    def draw(self, n_steps: int) -> Dict[str, torch.Tensor]:
        """The random draws of one ``train_device_steps(n_steps)`` call,
        from the model's generator, on its device. Skip-gram: the window
        choice ``dsel`` ``[S, M]`` (shifted-copy index 0..2W-1, the
        reference's random window shrink) and the subsampling uniforms
        ``u_center`` and ``u_ctx`` ``[S, M]``. CBOW: the window shrink
        ``shrink`` ``[S, M]``, ``u_center`` ``[S, M]`` and ``u_ctx`` ``[S,
        M, 2W]``. With negative sampling, the negatives ``negs`` ``[S,
        B/G, K]`` (pool slices, or exact alias draws when ``neg_pool_size``
        is 0)."""
        cfg = self.config
        W, B, K = cfg.window, cfg.batch_size, cfg.negative
        G = max(int(cfg.shared_negatives), 1)
        S, M = n_steps, self._candidate_batch(self._corpus_len)
        g, dev = self._gen, self.device
        shape = (S, M)
        shrink = torch.randint(1, W + 1, shape, generator=g, device=dev,
                               dtype=torch.int32)
        if cfg.cbow:
            out = {"shrink": shrink,
                   "u_ctx": torch.rand((S, M, 2 * W), generator=g,
                                       device=dev)}
        else:
            dmag = torch.minimum(
                torch.randint(1, W + 1, shape, generator=g, device=dev,
                              dtype=torch.int32), shrink)
            forward = torch.rand(shape, generator=g, device=dev) < 0.5
            # window offset -W..W (excl 0) -> shifted-copy index 0..2W-1
            out = {"dsel": torch.where(forward, W + dmag - 1, W - dmag),
                   "u_ctx": torch.rand(shape, generator=g, device=dev)}
        out["u_center"] = torch.rand(shape, generator=g, device=dev)
        if K > 0:
            n_rows = B // G
            if cfg.neg_pool_size > 0:
                pool = self._ensure_neg_pool(S * n_rows * K)
                out["negs"] = pool_negatives(g, pool, (S, n_rows, K))
            else:
                out["negs"] = sample_negatives(g, self._packed_alias,
                                               (S, n_rows, K))
        return out

    def _compact(self, ok: torch.Tensor, n_valid: torch.Tensor, B: int,
                 *arrays: torch.Tensor):
        """Pack the ``ok`` rows of each ``[M, ...]`` array into ``[B,
        ...]``: slot b takes the row whose inclusive survivor count first
        reaches b+1, slots past ``n_valid`` are zero. Returns the packed
        arrays and the ``[B]`` slot validity. ``compact_impl`` "scatter":
        each survivor is copied to its rank (rejected and overflow rows go
        to a dropped slot ``B``); "gather": ``searchsorted`` of 1..B over
        the survivor prefix sum, then one row gather per array. Both pack
        the same rows into the same slots."""
        M = ok.shape[0]
        valid = torch.arange(B, device=ok.device) < n_valid
        csum = torch.cumsum(ok.to(torch.int32), 0)
        packed = []
        if self.config.compact_impl == "gather":
            src = torch.searchsorted(
                csum, torch.arange(1, B + 1, device=ok.device,
                                   dtype=csum.dtype), side="left")
            src = torch.clamp(src, max=M - 1)
            for a in arrays:
                keep = valid.reshape((B,) + (1,) * (a.dim() - 1))
                packed.append(torch.where(keep, a[src],
                                          torch.zeros((), dtype=a.dtype,
                                                      device=a.device)))
            return tuple(packed) + (valid,)
        rank = csum - 1
        dest = torch.where(ok & (rank < B), rank,
                           torch.full_like(rank, B))
        for a in arrays:
            buf = torch.zeros((B + 1,) + tuple(a.shape[1:]), dtype=a.dtype,
                              device=a.device)
            packed.append(buf.index_copy_(0, dest, a)[:B])
        return tuple(packed) + (valid,)

    def _slab(self, start: int, M: int):
        """The candidate slab at ``start``: ``(ids, sentence ids, discard
        probabilities)``, each ``[M + 2W]`` (the M centers and W positions
        either side)."""
        L = M + 2 * self.config.window
        return tuple(b[start:start + L] for b in self._ext_bufs)

    def _sample_sg(self, start: int, M: int, dsel, u_center, u_ctx):
        """One step's skip-gram batch from the candidate slab at ``start``:
        centers are the next M corpus positions, each context the position
        ``dsel`` picks in its window; window, sentence and subsampling
        tests reject candidates, and the survivors are compacted into a
        dense ``[B]`` batch with a validity mask."""
        cfg = self.config
        W, B = cfg.window, cfg.batch_size
        buf, sbuf, dbuf = self._slab(start, M)
        centers, csent, cdisc = buf[W:W + M], sbuf[W:W + M], dbuf[W:W + M]
        pos = W + self._ctx_offsets[dsel.long()] + torch.arange(
            M, device=buf.device)
        contexts, xsent, xdisc = buf[pos], sbuf[pos], dbuf[pos]
        ok = (xsent == csent) & (u_center >= cdisc) & (u_ctx >= xdisc)
        if M > B:
            n_valid = torch.clamp(ok.sum(), max=B)
            centers, contexts, ok = self._compact(ok, n_valid, B, centers,
                                                  contexts)
        return centers, contexts, ok.to(torch.float32)

    def _sample_cbow(self, start: int, M: int, shrink, u_center, u_ctx):
        """One step's CBOW batch from the candidate slab at ``start``: each
        of the next M positions is a center with its 2W window slots, a
        slot valid inside the shrunk window, in the center's sentence and
        past the subsampling test (the center's and its own); examples
        with a valid slot are compacted into ``[B]`` and their slot masks
        ``[B, 2W]`` with them."""
        cfg = self.config
        W, B = cfg.window, cfg.batch_size
        buf, sbuf, dbuf = self._slab(start, M)
        centers, csent, cdisc = buf[W:W + M], sbuf[W:W + M], dbuf[W:W + M]
        pos = (W + self._ctx_offsets[None, :]
               + torch.arange(M, device=buf.device)[:, None])   # [M, 2W]
        contexts, xsent, xdisc = buf[pos], sbuf[pos], dbuf[pos]
        in_window = self._ctx_offsets.abs()[None, :] <= shrink[:, None]
        ok = (in_window & (xsent == csent[:, None])
              & (u_center >= cdisc)[:, None] & (u_ctx >= xdisc))
        if M > B:
            ex_ok = ok.any(dim=1)
            n_valid = torch.clamp(ex_ok.sum(), max=B)
            centers, contexts, ok, ex_packed = self._compact(
                ex_ok, n_valid, B, centers, contexts, ok)
            ok = ok & ex_packed[:, None]
        return centers, contexts, ok.to(torch.float32)

    def train_device_steps(self, n_steps: int,
                           draws: Optional[Dict[str, Any]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run ``n_steps`` sample+train iterations over the loaded corpus
        chunk. ``draws`` (see :meth:`draw`) replaces the model generator's
        draws. Returns ``(mean_loss, examples_trained)`` as device scalars:
        pairs for skip-gram, examples with a valid slot for CBOW."""
        if not hasattr(self, "_ext_bufs"):
            Log.fatal("call load_corpus_chunk() before train_device_steps()")
        cfg = self.config
        n = self._corpus_len
        M = self._candidate_batch(n)
        if draws is None:
            draws = self.draw(n_steps)
        draws = {k: (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v))).to(self.device)
                 for k, v in draws.items()}
        lr = _f32(self.current_lr())
        start0 = self._stream_pos % n
        self._stream_pos = (start0 + n_steps * M) % n
        sample = self._sample_cbow if cfg.cbow else self._sample_sg
        window = draws["shrink"] if cfg.cbow else draws["dsel"]
        negs = draws.get("negs")
        losses, counts = [], []
        with self.input_table._lock, self.output_table._lock:
            w_in, w_out = self.input_table._data, self.output_table._data
            for s in range(n_steps):
                c, t, m = sample((start0 + s * M) % n, M, window[s],
                                 draws["u_center"][s], draws["u_ctx"][s])
                losses.append(self._raw_step(
                    w_in, w_out, c, t, m, lr,
                    None if negs is None else negs[s]))
                counts.append((m.sum(dim=1) > 0).sum() if cfg.cbow
                              else m.sum())
            self.input_table.version += 1
            self.output_table.version += 1
        # lr decay bookkeeping without a sync: the expected valid fraction
        # (word units; a CBOW example is one center word)
        est = n_steps * cfg.batch_size * 0.5
        self._words_trained += est if cfg.cbow else self._pairs_to_words(est)
        return (torch.stack(losses).mean(),
                torch.stack(counts).sum().to(torch.float32))


def _refuse_unknown(cfg: Word2VecConfig) -> None:
    """An ``update_impl`` or ``compact_impl`` the JAX config does not
    name is an error (the JAX step would run any unknown ``update_impl``
    as ``scatter``)."""
    if cfg.update_impl not in _UPDATE_IMPLS:
        Log.fatal(f"unknown update_impl {cfg.update_impl!r} "
                  f"(scatter|segsum|split8)")
    if cfg.compact_impl not in ("gather", "scatter"):
        Log.fatal(f"unknown compact_impl {cfg.compact_impl!r} "
                  f"(gather|scatter)")


@dataclass
class HuffmanCodes:
    """Padded Huffman paths for HS (reference HuffmanEncoder output)."""

    paths: np.ndarray  # [vocab, L] inner-node ids
    codes: np.ndarray  # [vocab, L] bits (float)
    mask: np.ndarray   # [vocab, L] valid-step mask


def build_huffman(counts: np.ndarray, max_code_length: int = 40
                  ) -> HuffmanCodes:
    """Huffman tree over word counts (reference ``HuffmanEncoder``,
    ``WE/src/huffman_encoder.cpp``) as padded per-word paths, root first (a
    copy of the JAX package's numpy helper: the same codes, bit for
    bit)."""
    import heapq

    n = counts.shape[0]
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = {}
    binary = {}
    next_id = n
    while len(heap) > 1:
        c1, i1 = heapq.heappop(heap)
        c2, i2 = heapq.heappop(heap)
        parent[i1], parent[i2] = next_id, next_id
        binary[i1], binary[i2] = 0, 1
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    L = max_code_length
    paths = np.zeros((n, L), np.int32)
    codes = np.zeros((n, L), np.float32)
    mask = np.zeros((n, L), np.float32)
    for w in range(n):
        path, bits = [], []
        node = w
        while node in parent:
            bits.append(binary[node])
            node = parent[node]
            path.append(node)
        path = path[::-1][:L]
        bits = bits[::-1][:L]
        for j, (p, b) in enumerate(zip(path, bits)):
            paths[w, j] = p - n  # inner nodes numbered n..2n-2 -> 0..n-2
            codes[w, j] = b
            mask[w, j] = 1.0
    return HuffmanCodes(paths=paths, codes=codes, mask=mask)
