"""1-D dense parameter vector.

Counterpart of ``multiverso_tpu/tables/array_table.py`` (the reference
ArrayTable, ``src/table/array_table.cpp``): the whole vector is one tensor
on the session's device, with whole-table Get/Add.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .base import TableBase


class ArrayTable(TableBase):
    """``ArrayWorker``/``ArrayServer`` pair collapsed into one object."""

    def __init__(self, size: int, dtype: Any = torch.float32,
                 updater: Optional[str] = None, name: Optional[str] = None,
                 init_value: Optional[np.ndarray] = None,
                 device: Any = None) -> None:
        super().__init__((int(size),), dtype=dtype, updater=updater,
                         name=name, init_value=init_value, device=device)

    def get_into(self, out: np.ndarray) -> None:
        """Reference signature ``Get(T* data, size_t size)``."""
        np.copyto(out, self.get())
