"""Ops of the PyTorch port: attention (forward and backward, and sequence
parallel over a process group: ring and Ulysses) and embedding rows."""

from .embedding import embedding_lookup, scatter_add_rows, segment_mean_rows
from .flash_attention import (best_attention, flash_attention,
                              flash_attention_partial,
                              flash_attention_partial_bwd, merge_partials)
from .ring_attention import reference_attention, ring_attention
from .ulysses import ulysses_attention

__all__ = ["best_attention", "embedding_lookup", "flash_attention",
           "flash_attention_partial", "flash_attention_partial_bwd",
           "merge_partials", "reference_attention", "ring_attention",
           "scatter_add_rows", "segment_mean_rows", "ulysses_attention"]
