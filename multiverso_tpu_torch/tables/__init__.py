"""Parameter tables: device-resident state with Get/Add semantics.

Counterpart of ``multiverso_tpu/tables/``: the ``array`` and ``matrix``
tables. The JAX package's ``kv``, ``sparse`` and ``ftrl`` tables are not
ported yet (``create_table`` refuses them).
"""

from .base import AsyncHandle, TableBase
from .array_table import ArrayTable
from .matrix_table import MatrixTable

__all__ = ["AsyncHandle", "TableBase", "ArrayTable", "MatrixTable"]
