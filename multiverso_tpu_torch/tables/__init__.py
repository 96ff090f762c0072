"""Parameter tables: device-resident state with Get/Add semantics.

Counterpart of ``multiverso_tpu/tables/``: the ``array``, ``matrix``,
``sparse`` and ``ftrl`` tables (one tensor on the session's device each)
and the ``kv`` table (a host dict).
"""

from .base import AsyncHandle, TableBase
from .array_table import ArrayTable
from .kv_table import KVTable
from .matrix_table import MatrixTable
from .sparse_table import FTRLTable, SparseTable

__all__ = ["AsyncHandle", "TableBase", "ArrayTable", "FTRLTable", "KVTable",
           "MatrixTable", "SparseTable"]
