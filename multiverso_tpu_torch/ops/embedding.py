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

* :func:`embedding_lookup` — ``jnp.take(table, ids, axis=0)``: a negative
  id wraps, an id out of range gives a row of NaN.
* :func:`scatter_add_rows` — ``table.at[ids].add(deltas.astype(dtype))``:
  duplicates accumulate, a negative id wraps, an id out of range is
  dropped. It updates ``table`` IN PLACE and returns it, so a caller
  written for the functional JAX form still reads naturally.

A CPU tensor takes the plain version (:func:`_gather_plain`,
:func:`_scatter_add_plain`); a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches per kernel (the plain versions are not
counted).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"row_gather": 0, "row_scatter_add": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from .. import kernels

        lib = kernels.load(name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "row_gather":
            fn = lib.mv_row_gather
            fn.argtypes = [p, p, p, ll, ll, i, i, p]
        else:
            fn = lib.mv_row_scatter_add
            fn.argtypes = [p, p, p, ll, ll, i, i, i, p]
        fn.restype = i
        _fns[name] = fn
    return fn


def _wrapped(ids: torch.Tensor, rows: int):
    """``(ids as int64 with negatives wrapped, in-range mask)``."""
    w = ids.reshape(-1).long()
    w = torch.where(w < 0, w + rows, w)
    return w, (w >= 0) & (w < rows)


# -- plain versions -----------------------------------------------------------

def _gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    w, ok = _wrapped(ids, table.shape[0])
    out = table.index_select(0, torch.where(ok, w, torch.zeros_like(w)))
    out = out.masked_fill(~ok.reshape((-1,) + (1,) * (table.dim() - 1)),
                          float("nan"))
    return out.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def _scatter_add_plain(table: torch.Tensor, ids: torch.Tensor,
                       deltas: torch.Tensor) -> torch.Tensor:
    w, ok = _wrapped(ids, table.shape[0])
    d = deltas.reshape((w.shape[0],) + tuple(table.shape[1:])).to(table.dtype)
    table.index_add_(0, w[ok], d[ok])
    return table


# -- CUDA launches ------------------------------------------------------------

def _check_table(table: torch.Tensor, op: str) -> None:
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: table dtype {table.dtype} not supported "
                        f"(float32 or bfloat16)")
    if table.dim() < 1 or table.shape[0] == 0 or not table.is_contiguous():
        raise ValueError(f"{op}: table must be a non-empty contiguous "
                         f"[rows, ...] tensor, got {tuple(table.shape)}")


def _check_ids(ids: torch.Tensor, table: torch.Tensor, op: str) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"{op}: ids must be int32 on the card, got "
                        f"{ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"{op}: ids on {ids.device}, table on "
                         f"{table.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _gather_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    _check_table(table, "embedding_lookup")
    _check_ids(ids, table, "embedding_lookup")
    ids = ids.contiguous()
    out = torch.empty(tuple(ids.shape) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=table.device)
    n = ids.numel()
    if n == 0:
        return out
    item = table.element_size()
    row_bytes = (table.numel() // table.shape[0]) * item
    fn = _kernel("row_gather")
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n,
                 table.shape[0], row_bytes, item, _stream(table))
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["row_gather"] += 1
    return out


def _scatter_add_cuda(table: torch.Tensor, ids: torch.Tensor,
                      deltas: torch.Tensor) -> torch.Tensor:
    _check_table(table, "scatter_add_rows")
    _check_ids(ids, table, "scatter_add_rows")
    if deltas.device != table.device:
        raise ValueError(f"scatter_add_rows: deltas on {deltas.device}, "
                         f"table on {table.device}")
    n = ids.numel()
    D = table.numel() // table.shape[0]
    if deltas.numel() != n * D:
        raise ValueError(f"scatter_add_rows: deltas {tuple(deltas.shape)} "
                         f"do not match {n} ids of rows of {D}")
    if table.dtype == torch.float32 and deltas.dtype != torch.float32:
        deltas = deltas.float()          # exact: every bf16 is an f32
    if deltas.dtype not in _DTYPE_CODES:
        raise TypeError(f"scatter_add_rows: deltas dtype {deltas.dtype} not "
                        f"supported (float32 or bfloat16)")
    if table.dtype == torch.bfloat16 and D % 2:
        raise ValueError(f"scatter_add_rows: a bfloat16 table needs an even "
                         f"row width (pairwise atomics), got {D}")
    ids, deltas = ids.contiguous(), deltas.contiguous()
    align = 2 * deltas.element_size()
    if (table.dtype == torch.bfloat16
            and (table.data_ptr() % 4 or deltas.data_ptr() % align)):
        raise ValueError("scatter_add_rows: bfloat16 table or deltas not "
                         "aligned for pairwise atomics")
    if n == 0:
        return table
    fn = _kernel("row_scatter_add")
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), ids.data_ptr(), deltas.data_ptr(), n,
                 table.shape[0], D, _DTYPE_CODES[table.dtype],
                 _DTYPE_CODES[deltas.dtype], _stream(table))
    if err != 0:
        raise RuntimeError(f"row_scatter_add kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["row_scatter_add"] += 1
    return table


# -- public ops ---------------------------------------------------------------

def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows: ``[vocab, dim] x ids[...] -> [..., dim]``."""
    if table.device.type == "cpu":
        return _gather_plain(table, ids)
    if table.device.type == "cuda":
        return _gather_cuda(table, ids)
    raise ValueError(f"embedding_lookup: unsupported device {table.device}")


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     deltas: torch.Tensor) -> torch.Tensor:
    """Scatter-accumulate row deltas into ``table`` in place (duplicates
    sum; each delta rounded to the table dtype first); returns ``table``."""
    if table.device.type == "cpu":
        return _scatter_add_plain(table, ids, deltas)
    if table.device.type == "cuda":
        return _scatter_add_cuda(table, ids, deltas)
    raise ValueError(f"scatter_add_rows: unsupported device {table.device}")


def segment_mean_rows(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Mean-combine rows per segment (CBOW context averaging). Plain
    PyTorch: CBOW is not on the ported path yet."""
    seg = segment_ids.long()
    sums = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                       dtype=values.dtype, device=values.device)
    sums.index_add_(0, seg, values)
    counts = torch.zeros((num_segments,), dtype=values.dtype,
                         device=values.device)
    counts.index_add_(0, seg, torch.ones_like(seg, dtype=values.dtype))
    return sums / torch.clamp(counts, min=1.0)[:, None]
