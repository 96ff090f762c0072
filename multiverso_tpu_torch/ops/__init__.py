"""Ops of the PyTorch port: attention (forward) and embedding rows."""

from .embedding import embedding_lookup, scatter_add_rows, segment_mean_rows
from .flash_attention import (best_attention, flash_attention,
                              flash_attention_partial, merge_partials)
from .ring_attention import reference_attention

__all__ = ["best_attention", "embedding_lookup", "flash_attention",
           "flash_attention_partial", "merge_partials", "reference_attention",
           "scatter_add_rows", "segment_mean_rows"]
