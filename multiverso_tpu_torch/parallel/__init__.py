"""Host-side pipelining, the parameter-server planes and the collectives
(counterpart of ``multiverso_tpu/parallel``): the double buffer, the
loader thread, the pipelined table getter, the peer-to-peer transport,
the async-PS record framing with its epoch fence and the delta bus
(``async_ps``), the SSP clock (``ssp``), the heartbeat failure detector
(``health``), and the collectives over the process group
(``collectives``, ``allreduce_engine``), the BSP train step
(``sync_step``), and GPipe and 1F1B pipeline parallelism over a
``stage`` axis (``pipeline``)."""

from .allreduce_engine import AllreduceEngine
from .async_buffer import ASyncBuffer, PipelinedGetter, prefetch_iterator
from .async_ps import AsyncDeltaBus
from .collectives import (all_gather, all_to_all, allreduce,
                          allreduce_replicated, reduce_scatter, ring_shift)
from .health import FailureDetector
from .p2p import P2PTransport, reconnect_backoff_s
from .pipeline import (STAGE_AXIS, make_pipeline_mesh, microbatch,
                       pipeline_apply, stack_stage_params)
from .ssp import SSPClock
from .sync_step import make_sync_step

__all__ = ["ASyncBuffer", "AllreduceEngine", "AsyncDeltaBus",
           "FailureDetector", "P2PTransport", "PipelinedGetter", "SSPClock",
           "STAGE_AXIS", "all_gather", "all_to_all", "allreduce",
           "allreduce_replicated", "make_pipeline_mesh", "make_sync_step",
           "microbatch", "pipeline_apply", "prefetch_iterator",
           "reconnect_backoff_s", "reduce_scatter", "ring_shift",
           "stack_stage_params"]
