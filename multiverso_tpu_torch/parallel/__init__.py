"""Host-side pipelining (counterpart of ``multiverso_tpu/parallel``): the
loader thread. The distributed pieces of the JAX package wait for the
distributed slice (ROADMAP.md Queue 1 item 8)."""

from .async_buffer import prefetch_iterator

__all__ = ["prefetch_iterator"]
