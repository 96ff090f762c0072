"""Host-side pipelining and the parameter-server planes (counterpart of
``multiverso_tpu/parallel``): the double buffer, the loader thread, the
pipelined table getter, the peer-to-peer transport, the async-PS record
framing with its epoch fence and the delta bus (``async_ps``), the SSP
clock (``ssp``) and the heartbeat failure detector (``health``). The
device-mesh collectives of the JAX package (``collectives``,
``allreduce_engine``, ``sync_step``, ``pipeline``) are not here."""

from .async_buffer import ASyncBuffer, PipelinedGetter, prefetch_iterator
from .async_ps import AsyncDeltaBus
from .health import FailureDetector
from .p2p import P2PTransport, reconnect_backoff_s
from .ssp import SSPClock

__all__ = ["ASyncBuffer", "AsyncDeltaBus", "FailureDetector",
           "P2PTransport", "PipelinedGetter", "SSPClock",
           "prefetch_iterator", "reconnect_backoff_s"]
