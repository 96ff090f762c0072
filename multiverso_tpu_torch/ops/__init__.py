"""Ops of the PyTorch port: attention (forward and backward, and sequence
parallel over a process group: ring and Ulysses), embedding rows, and the
expert-parallel top-1 MoE layer."""

from .embedding import embedding_lookup, scatter_add_rows, segment_mean_rows
from .flash_attention import (best_attention, flash_attention,
                              flash_attention_partial,
                              flash_attention_partial_bwd, merge_partials)
from .moe import (EXPERT_AXIS, init_moe_params, mlp_expert, moe_apply,
                  top1_gating)
from .ring_attention import (reference_attention, ring_attention,
                             ring_prefill_attention)
from .ulysses import ulysses_attention, ulysses_prefill_attention

__all__ = ["EXPERT_AXIS", "best_attention", "embedding_lookup",
           "flash_attention", "flash_attention_partial",
           "flash_attention_partial_bwd", "init_moe_params", "merge_partials",
           "mlp_expert", "moe_apply", "reference_attention", "ring_attention",
           "ring_prefill_attention", "scatter_add_rows", "segment_mean_rows",
           "top1_gating", "ulysses_attention", "ulysses_prefill_attention"]
