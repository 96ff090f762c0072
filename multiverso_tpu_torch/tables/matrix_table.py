"""Row-major 2-D parameter table with per-row Get/Add and sparse semantics.

Counterpart of ``multiverso_tpu/tables/matrix_table.py`` (the reference
dense and sparse matrix tables, ``src/table/matrix_table.cpp`` and
``src/table/sparse_matrix_table.cpp``):

* row Get is the row-gather kernel and row Add the row-scatter-add kernel
  (``ops.embedding``), on the table's one device tensor;
* ``get_rows`` keeps the JAX table's ``data[ids]`` semantics: a negative
  id wraps and an id out of range is clamped to the last (or first) row,
  so the ids are clamped before the gather;
* ``add_rows`` keeps ``.at[ids].add`` semantics: duplicates accumulate and
  an id out of range is dropped;
* the sparse dirty-row protocol (``get_dirty_rows``) is a host-side bitmap,
  as in the JAX package, and a peer's dense delta through
  ``_apply_remote_dense`` dirties every row (JAX :150-157).

The JAX package buckets row requests to power-of-two sizes
(``tables/_rowops.py``) so that XLA compiles each size once. PyTorch runs
eagerly and the kernels take any row count, so that module is not ported.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..log import Log
from ..ops.embedding import embedding_lookup, scatter_add_rows
from ..updaters import AddOption, GetOption
from .base import AsyncHandle, TableBase, host_to_tensor, tensor_to_host


class MatrixTable(TableBase):
    """Dense/sparse row-major matrix (``MatrixWorker``+``MatrixServer``)."""

    def __init__(
        self,
        num_row: int,
        num_col: int,
        dtype: Any = torch.float32,
        updater: Optional[str] = None,
        name: Optional[str] = None,
        init_value: Optional[Any] = None,
        is_sparse: bool = False,
        is_pipeline: bool = False,
        seed: int = 0,
        num_sim_workers: Optional[int] = None,
        device: Any = None,
    ) -> None:
        num_row, num_col = int(num_row), int(num_col)
        if isinstance(init_value, str):
            if init_value != "random":
                Log.fatal(f"unknown init_value {init_value!r}")
            # reference random-init server ctor (matrix_table.cpp:372-384):
            # (U[0,1) - 0.5) / num_col, the same float64 numpy draw as the
            # JAX table, so one seed gives the same bits in both packages
            rng = np.random.default_rng(seed)
            init_value = (rng.random((num_row, num_col)) - 0.5) / num_col
        super().__init__((num_row, num_col), dtype=dtype, updater=updater,
                         name=name, init_value=init_value,
                         num_sim_workers=num_sim_workers, device=device)
        self.num_row, self.num_col = num_row, num_col
        self.is_sparse = bool(is_sparse)
        self.is_pipeline = bool(is_pipeline)  # option parity only
        self._dirty = (np.zeros((self.num_worker_slots, num_row), dtype=bool)
                       if self.is_sparse else None)

    # -- row API (reference matrix_table.h:25-75) --------------------------
    def get_rows(self, row_ids: Any,
                 option: Optional[GetOption] = None) -> np.ndarray:
        """Gather a list of rows -> host ``[len(row_ids), num_col]`` (float32
        for a bfloat16 table)."""
        ids = np.asarray(row_ids, dtype=np.int64).ravel()
        ids = np.where(ids < 0, ids + self.num_row, ids)
        ids = np.clip(ids, 0, self.num_row - 1).astype(np.int32)
        ids_t = torch.from_numpy(ids).to(self.device)
        with self._lock:
            out = embedding_lookup(self._data, ids_t)
        return tensor_to_host(out)

    def get_row(self, row_id: int) -> np.ndarray:
        return self.get_rows([row_id])[0]

    def _dispatch_keyed(self, ids: np.ndarray, vals: Any,
                        option: AddOption) -> int:
        """Scatter-apply row deltas; returns the post-apply version.
        Stateless updaters add ``sign * vals`` straight into the table;
        stateful ones scatter into a zero delta and run their ``apply``."""
        ids = np.asarray(ids, dtype=np.int32).ravel()
        n = ids.shape[0]
        vals_t = host_to_tensor(
            vals.reshape(n, self.num_col) if isinstance(vals, torch.Tensor)
            else np.asarray(vals).reshape(n, self.num_col), self.dtype,
            self.device)
        ids_t = torch.from_numpy(ids).to(self.device)
        if self._dirty is not None:
            self._mark_dirty(ids, option.worker_id)
        updater = self.updater
        with self._lock:
            if updater.stateless:
                contrib = vals_t if updater.sign == 1.0 \
                    else vals_t * updater.sign
                scatter_add_rows(self._data, ids_t, contrib)
            else:
                dense = scatter_add_rows(torch.zeros_like(self._data), ids_t,
                                         vals_t)
                self._data, self._ustate = updater.apply(
                    self._data, self._ustate, dense, option)
            self.version += 1
            return self.version

    def add_rows_async(self, row_ids: Any, values: Any,
                       option: Optional[AddOption] = None) -> AsyncHandle:
        """Scatter-apply deltas into a set of rows (``Add(row_ids, ...)``)."""
        option = self._default_option(option)
        self._dispatch_keyed(row_ids, values, option)
        return self._add_handle()

    def add_rows(self, row_ids: Any, values: Any,
                 option: Optional[AddOption] = None) -> None:
        self.add_rows_async(row_ids, values, option).wait()

    def add_row(self, row_id: int, values: Any,
                option: Optional[AddOption] = None) -> None:
        self.add_rows([row_id], np.asarray(values)[None, :], option)

    # whole-table add also feeds the dirty bitmap
    def add_async(self, delta: Any,
                  option: Optional[AddOption] = None) -> AsyncHandle:
        if self._dirty is not None:
            wid = option.worker_id if option else max(self._sess.worker_id, 0)
            self._mark_dirty(np.arange(self.num_row), wid)
        return super().add_async(delta, option)

    def _apply_remote_dense(self, host: Any, option: AddOption) -> None:
        # a peer's whole-table delta dirties every row for local pullers,
        # as a local whole-table add does (keyed remote applies mark their
        # rows in _dispatch_keyed)
        if self._dirty is not None:
            self._mark_dirty(np.arange(self.num_row), option.worker_id)
        super()._apply_remote_dense(host, option)

    # -- sparse dirty-row protocol ----------------------------------------
    def _mark_dirty(self, rows: np.ndarray, adding_worker: int) -> None:
        """``UpdateAddState``: rows become dirty for every *other* worker
        (``sparse_matrix_table.cpp:200-224``)."""
        with self._lock:
            for w in range(self._dirty.shape[0]):
                if w != adding_worker:
                    self._dirty[w, rows] = True

    def get_dirty_rows(self, worker_id: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """``UpdateGetState`` + sparse reply: (row_ids, rows) updated by
        other workers since this worker's last call; clears the bitmap. An
        empty set when no row is dirty (the JAX package's deviation from the
        reference's sentinel row 0)."""
        if self._dirty is None:
            Log.fatal("get_dirty_rows requires is_sparse=True")
        with self._lock:
            rows = np.flatnonzero(self._dirty[worker_id])
            self._dirty[worker_id, rows] = False
        if rows.size == 0:
            return rows.astype(np.int32), np.empty((0, self.num_col),
                                                    np.float32)
        return rows.astype(np.int32), self.get_rows(rows)
