"""Host-side pipelining and the record wire (counterpart of
``multiverso_tpu/parallel``): the loader thread, the peer-to-peer
transport, and the async-PS record framing with its epoch fence
(``async_ps``). The distributed training paths of the JAX package, the
delta bus among them, wait for the distributed slice (ROADMAP.md Queue 1
item 8)."""

from .async_buffer import prefetch_iterator
from .p2p import P2PTransport, reconnect_backoff_s

__all__ = ["P2PTransport", "prefetch_iterator", "reconnect_backoff_s"]
