"""Embedding row gather and row scatter-add: hand-written CUDA kernels and
their plain versions.

Counterpart of ``multiverso_tpu/ops/embedding.py``. The JAX module leaves
both operations to XLA (``jnp.take``, ``.at[ids].add``); their Pallas
versions are the kernel probe's ``pallas_gather`` / ``subtile_rejected``
(row gather) and ``pallas_rmw`` (duplicate-safe read-modify-write) in
``tools/w2v_kernel_probe.py``, refused on the TPU only because its smallest
HBM slice is an 8-row tile. Here they are ``csrc/row_gather.cu`` and
``csrc/row_scatter_add.cu``, and every embedding-row gather and row
scatter-add of the word2vec step and of ``MatrixTable`` goes through them.

* :func:`embedding_lookup` — ``jnp.take(table, ids, axis=0)``, optionally
  widened to float32 (``.astype(jnp.float32)``): a negative id wraps, an
  id out of range gives a row of NaN.
* :func:`scatter_add_rows` — ``table.at[ids].add((coef * deltas)
  .astype(dtype))`` with ``coef`` = ``alpha`` times an optional per-row
  scale: duplicates accumulate one rounded add at a time, a negative id
  wraps, an id out of range is dropped. It updates ``table`` IN PLACE and
  returns it, so a caller written for the functional JAX form still reads
  naturally.

A CPU tensor takes the plain version (:func:`_gather_plain`,
:func:`_scatter_add_plain`); a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches per kernel (the plain versions are not
counted).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import kernels

LAUNCHES: Dict[str, int] = {"row_gather": 0, "row_scatter_add": 0}

_SUPPORTED = (torch.float32, torch.bfloat16)
# row_gather.cu's mode bits and row_scatter_add.cu's dtype bits
_GATHER_BF16, _GATHER_WIDEN = 1, 2
_SCATTER_TABLE_BF16, _SCATTER_DELTAS_BF16 = 1, 2
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GATHER_ARGS = (_P, _P, _P, _LL, _LL, _I, _I, _I, _P)
_SCATTER_ARGS = (_P, _P, _P, _P, ctypes.c_float, _LL, _LL, _I, _I, _I, _P)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _wrapped(ids: torch.Tensor, rows: int):
    """``(ids as int64 with negatives wrapped, in-range mask)``."""
    w = ids.reshape(-1).long()
    w = torch.where(w < 0, w + rows, w)
    return w, (w >= 0) & (w < rows)


# -- plain versions -----------------------------------------------------------

def _gather_plain(table: torch.Tensor, ids: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    w, ok = _wrapped(ids, table.shape[0])
    out = table.index_select(0, torch.where(ok, w, torch.zeros_like(w)))
    if out_dtype is not None:
        out = out.to(out_dtype)
    out = out.masked_fill(~ok.reshape((-1,) + (1,) * (table.dim() - 1)),
                          float("nan"))
    return out.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def _landing_deltas(table: torch.Tensor, ids: torch.Tensor,
                    deltas: torch.Tensor, alpha: Optional[float] = None,
                    row_scale: Optional[torch.Tensor] = None):
    """``(wrapped ids, in-range mask, deltas)``: the deltas as they reach
    the table, ``coef * deltas`` in f32 (``coef`` = ``row_scale[id] *
    alpha``, that product first, as the JAX step takes it) rounded to the
    table dtype, one row per id."""
    w, ok = _wrapped(ids, table.shape[0])
    d = deltas.reshape((w.shape[0],) + tuple(table.shape[1:]))
    if alpha is not None or row_scale is not None:
        coef = 1.0 if alpha is None else alpha
        if row_scale is not None:
            coef = (row_scale[torch.where(ok, w, torch.zeros_like(w))]
                    * coef).reshape((-1,) + (1,) * (d.dim() - 1))
        d = coef * d.float()
    return w, ok, d.to(table.dtype)


def _scatter_add_plain(table: torch.Tensor, ids: torch.Tensor,
                       deltas: torch.Tensor, alpha: Optional[float] = None,
                       row_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Each add rounded to the table dtype on its own, a row's adds in
    index order, as XLA's scatter does on the CPU: pass r adds every row's
    r-th delta (one ``index_add_`` of distinct rows)."""
    w, ok, d = _landing_deltas(table, ids, deltas, alpha, row_scale)
    w, d = w[ok], d[ok]
    if w.numel() == 0:
        return table
    order = torch.argsort(w, stable=True)
    sw = w[order]
    rank = torch.empty_like(w)
    rank[order] = (torch.arange(w.numel(), device=w.device)
                   - torch.searchsorted(sw, sw))
    by_rank = torch.argsort(rank, stable=True)
    w, d = w[by_rank], d[by_rank]
    start = 0
    for size in torch.bincount(rank).tolist():
        table.index_add_(0, w[start:start + size], d[start:start + size])
        start += size
    return table


# -- CUDA launches ------------------------------------------------------------

def _check_table(table: torch.Tensor, op: str) -> None:
    if table.dtype not in _SUPPORTED:
        raise TypeError(f"{op}: table dtype {table.dtype} not supported "
                        f"(float32 or bfloat16)")
    if table.dim() < 1 or table.shape[0] == 0 or not table.is_contiguous():
        raise ValueError(f"{op}: table must be a non-empty contiguous "
                         f"[rows, ...] tensor, got {tuple(table.shape)}")


def _row_elems(table: torch.Tensor) -> int:
    """Elements in one row of a contiguous table. Not ``stride(0)``: a
    contiguous ``[1, D]`` view may carry any stride in its size-1 dim."""
    return table.numel() // table.shape[0]


def _check_on(t: torch.Tensor, dev: int, what: str, op: str) -> None:
    if not t.is_cuda or t.get_device() != dev:
        raise ValueError(f"{op}: {what} on {t.device}, table on cuda:{dev}")


def _check_ids(ids: torch.Tensor, dev: int, op: str) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"{op}: ids must be int32 on the card, got "
                        f"{ids.dtype}")
    _check_on(ids, dev, "ids", op)


def _gather_cuda(table: torch.Tensor, ids: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    _check_table(table, "embedding_lookup")
    dev, stream = kernels.launch_target(table)
    _check_ids(ids, dev, "embedding_lookup")
    mode = _GATHER_BF16 if table.dtype == torch.bfloat16 else 0
    if out_dtype is None or out_dtype == table.dtype:
        out = table.new_empty(ids.shape + table.shape[1:])
    elif out_dtype == torch.float32:
        mode |= _GATHER_WIDEN
        out = table.new_empty(ids.shape + table.shape[1:],
                              dtype=torch.float32)
    else:
        raise TypeError(f"embedding_lookup: out_dtype {out_dtype} from a "
                        f"{table.dtype} table (the table's dtype, or "
                        f"float32 from bfloat16)")
    n = ids.numel()
    if n == 0:
        return out
    ids = ids.contiguous()
    err = kernels.bind("row_gather", "mv_row_gather", _GATHER_ARGS)(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, table.shape[0],
        _row_elems(table) * table.element_size(), mode, dev, stream)
    kernels.check_launch(err, "row_gather")
    LAUNCHES["row_gather"] += 1
    return out


def _scatter_add_cuda(table: torch.Tensor, ids: torch.Tensor,
                      deltas: torch.Tensor, alpha: Optional[float] = None,
                      row_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    op = "scatter_add_rows"
    _check_table(table, op)
    dev, stream = kernels.launch_target(table)
    _check_ids(ids, dev, op)
    _check_on(deltas, dev, "deltas", op)
    if deltas.dtype not in _SUPPORTED:
        raise TypeError(f"{op}: deltas dtype {deltas.dtype} not supported "
                        f"(float32 or bfloat16)")
    rows = table.shape[0]
    n = ids.numel()
    D = _row_elems(table)
    if deltas.numel() != n * D:
        raise ValueError(f"{op}: deltas {tuple(deltas.shape)} do not match "
                         f"{n} ids of rows of {D}")
    if table.dtype == torch.bfloat16 and D % 2:
        raise ValueError(f"{op}: a bfloat16 table needs an even row width "
                         f"(pairwise atomics), got {D}")
    scale_ptr = None
    if row_scale is not None:
        _check_on(row_scale, dev, "row_scale", op)
        if (row_scale.dtype != torch.float32 or row_scale.numel() != rows
                or not row_scale.is_contiguous()):
            raise ValueError(f"{op}: row_scale must be a contiguous float32 "
                             f"[{rows}] table, got {row_scale.dtype} "
                             f"{tuple(row_scale.shape)}")
        scale_ptr = row_scale.data_ptr()
    if table.dtype == torch.float32:
        deltas = deltas.float()     # exact; the kernel takes f32 deltas here
    ids, deltas = ids.contiguous(), deltas.contiguous()
    narrow = 2 * deltas.element_size()
    if (table.dtype == torch.bfloat16
            and (table.data_ptr() % 4 or deltas.data_ptr() % narrow)):
        raise ValueError(f"{op}: bfloat16 table or deltas not aligned for "
                         f"pairwise atomics")
    if n == 0:
        return table
    dtypes = ((_SCATTER_TABLE_BF16 if table.dtype == torch.bfloat16 else 0)
              | (_SCATTER_DELTAS_BF16 if deltas.dtype == torch.bfloat16
                 else 0))
    err = kernels.bind("row_scatter_add", "mv_row_scatter_add",
                       _SCATTER_ARGS)(
        table.data_ptr(), ids.data_ptr(), deltas.data_ptr(), scale_ptr,
        1.0 if alpha is None else alpha, n, rows, D, dtypes, dev, stream)
    kernels.check_launch(err, "row_scatter_add")
    LAUNCHES["row_scatter_add"] += 1
    return table


# -- public ops ---------------------------------------------------------------

def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """Gather rows: ``[vocab, dim] x ids[...] -> [..., dim]``, in the
    table's dtype, or in ``out_dtype=torch.float32`` from a bfloat16 table
    (widened exactly, by the kernel)."""
    if table.is_cuda:
        return _gather_cuda(table, ids, out_dtype)
    if table.is_cpu:
        return _gather_plain(table, ids, out_dtype)
    raise ValueError(f"embedding_lookup: unsupported device {table.device}")


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     deltas: torch.Tensor, alpha: Optional[float] = None,
                     row_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``table[ids[i]] += to_table_dtype(coef_i * deltas[i])`` in place;
    returns ``table``. ``coef_i`` is ``row_scale[ids[i]] * alpha`` (that
    product first) with a float32 ``[rows]`` scale table, ``alpha`` without
    one; the products are float32 (``alpha`` taken as a float32). With
    neither, each delta is only rounded to the table dtype. Every add is
    rounded on its own: duplicates are never combined first."""
    if table.is_cuda:
        return _scatter_add_cuda(table, ids, deltas, alpha, row_scale)
    if table.is_cpu:
        return _scatter_add_plain(table, ids, deltas, alpha, row_scale)
    raise ValueError(f"scatter_add_rows: unsupported device {table.device}")


def segment_mean_rows(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Mean-combine rows per segment (the JAX module's helper, XLA ops
    there too). Plain PyTorch: no step calls it; CBOW's mean is an einsum
    over the row gather's ``[B, 2W, D]`` rows, as in the JAX step."""
    seg = segment_ids.long()
    sums = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                       dtype=values.dtype, device=values.device)
    sums.index_add_(0, seg, values)
    counts = torch.zeros((num_segments,), dtype=values.dtype,
                         device=values.device)
    counts.index_add_(0, seg, torch.ones_like(seg, dtype=values.dtype))
    return sums / torch.clamp(counts, min=1.0)[:, None]
