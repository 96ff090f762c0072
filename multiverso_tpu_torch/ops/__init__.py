"""Attention ops of the PyTorch port (forward)."""

from .flash_attention import (best_attention, flash_attention,
                              flash_attention_partial, merge_partials)
from .ring_attention import reference_attention

__all__ = ["best_attention", "flash_attention", "flash_attention_partial",
           "merge_partials", "reference_attention"]
