"""Host-side pipelining and the record wire (counterpart of
``multiverso_tpu/parallel``): the loader thread and the peer-to-peer
transport. The distributed training paths of the JAX package wait for
the distributed slice (ROADMAP.md Queue 1 item 8)."""

from .async_buffer import prefetch_iterator
from .p2p import P2PTransport, reconnect_backoff_s

__all__ = ["P2PTransport", "prefetch_iterator", "reconnect_backoff_s"]
