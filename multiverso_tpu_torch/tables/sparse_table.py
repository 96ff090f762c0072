"""Key-addressed sparse parameter vector and its FTRL variant.

Counterpart of ``multiverso_tpu/tables/sparse_table.py`` (the
LogisticRegression app's tables, ``LR/src/util/sparse_table.h`` and
``util/ftrl_sparse_table.h`` in the Multiverso reference). "Sparse" is the
access pattern: the state is one dense tensor on the table's device, and
only the touched keys move.

* :class:`SparseTable` — a ``[size]`` vector. ``get_keys`` is the row
  gather kernel at rows of one element (``ops.embedding.embedding_lookup``,
  4-byte rows); ``add_keys`` the row scatter-add kernel
  (``scatter_add_rows``): a stateless updater adds ``sign * vals`` in
  place, a stateful one scatters into a zero ``[size]`` delta and runs its
  ``apply`` on the whole vector, as the JAX table does.
* :class:`FTRLTable` — the ``(z, n)`` pair of each key as a ``[size, 2]``
  table (8-byte rows) whose updater is always ``default``: ``add_keys``
  accumulates ``(delta_z, delta_n)`` with the scatter-add kernel and waits
  for it, as the JAX table's ``block_until_ready`` does.

Keys keep the JAX table's rules: they are cast to int32; a Get wraps a
negative key once and clamps the result into ``[0, size)`` (``data[ids]``),
so keys are clamped before the gather (the kernel itself gives NaN for an
id out of range); an Add wraps a negative key once and drops a key out of
range (``.at[ids].add``), the scatter kernel's own rule. Repeated keys in
one Add accumulate. The JAX table pads each request to a power-of-two
bucket with masked rows so that XLA compiles each size once
(``tables/_rowops.py``); the kernels take any count, so nothing is padded.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..updaters import AddOption, GetOption
from .base import AsyncHandle, TableBase


class SparseTable(TableBase):
    """Keyed sparse vector (``SparseWorkerTable``/``SparseServerTable``)."""

    def __init__(self, size: int, dtype: Any = torch.float32,
                 updater: Optional[str] = None, name: Optional[str] = None,
                 init_value: Optional[np.ndarray] = None,
                 device: Any = None) -> None:
        super().__init__((int(size),), dtype=dtype, updater=updater,
                         name=name, init_value=init_value, device=device)

    # -- keyed API (sparse_table.h:44-116) ---------------------------------
    def get_keys(self, keys: Any,
                 option: Optional[GetOption] = None) -> np.ndarray:
        """``GetAsync(keys, data)``: the values of a keyset, on the host."""
        return self._gather_keys(keys)

    def add_keys_async(self, keys: Any, values: Any,
                       option: Optional[AddOption] = None) -> AsyncHandle:
        option = self._default_option(option)
        self._add_keyed_local(keys, values, option)
        return self._add_handle()

    def add_keys(self, keys: Any, values: Any,
                 option: Optional[AddOption] = None) -> None:
        self.add_keys_async(keys, values, option).wait()


class FTRLTable(TableBase):
    """FTRL state table: per-key ``(z, n)`` (``ftrl_sparse_table.h:12-90``).
    The reference's ``sqrtn`` is a derived cache, recomputed by the model."""

    Z, N = 0, 1  # column layout

    def __init__(self, size: int, dtype: Any = torch.float32,
                 name: Optional[str] = None, device: Any = None) -> None:
        # FTRL accumulates with += on the server side (the closed-form
        # weights are the worker's): the default updater, always
        super().__init__((int(size), 2), dtype=dtype, updater="default",
                         name=name, device=device)

    def get_keys(self, keys: Any) -> Tuple[np.ndarray, np.ndarray]:
        """``(z, n)`` host arrays for the keyset."""
        zn = self._gather_keys(keys)
        return zn[:, self.Z], zn[:, self.N]

    def add_keys(self, keys: Any, delta_z: Any, delta_n: Any) -> None:
        """Accumulate ``FTRLGradient{delta_z, delta_n}`` per key, then wait
        for the device."""
        # float64 holds any delta exactly; the table's cast rounds it
        vals = np.stack([np.asarray(delta_z, np.float64).ravel(),
                         np.asarray(delta_n, np.float64).ravel()], axis=1)
        self._add_keyed_local(keys, vals, None)
        self.flush()
