"""Serving subsystem of the PyTorch port: micro-batched workloads and the
continuous-batching decode engine behind an in-process
:class:`InferenceServer`, and the serving fleet: a :class:`FleetRouter`
front door over :class:`ReplicaServer` replicas on the ``mvserve`` wire,
with seeded fault injection (:class:`FaultPlan`), and the fleet's two
planes: observability (:class:`ObsAgent`, :class:`ObsCollector`, label
``mvobs``) and parameters (:class:`ParamPublisher`,
:class:`ParamSubscriber`, label ``mvparam``)."""

from .batcher import (BatcherConfig, DeadlineExceededError, MicroBatcher,
                      OverloadedError, bucket_for, shape_buckets)
from .decode_engine import DecodeEngine, DecodeEngineConfig
from .faultinject import FaultPlan
from .obs_plane import ObsAgent, ObsCollector
from .param_plane import ParamPublisher, ParamSubscriber
from .replica import ReplicaServer, serve_replica
from .router import FleetConfig, FleetError, FleetRouter, retry_backoff_s
from .server import InferenceServer
from .snapshot import (DerivedCache, Snapshot, SnapshotManager,
                       quantize_decode_params)
from .workloads import (EmbeddingNeighbors, FTRLPredict, LMGreedyDecode,
                        LogRegPredict)

__all__ = ["BatcherConfig", "DeadlineExceededError", "DecodeEngine",
           "DecodeEngineConfig", "DerivedCache", "EmbeddingNeighbors",
           "FTRLPredict", "FaultPlan", "FleetConfig", "FleetError",
           "FleetRouter", "InferenceServer", "LMGreedyDecode",
           "LogRegPredict", "MicroBatcher",
           "ObsAgent", "ObsCollector", "OverloadedError", "ParamPublisher",
           "ParamSubscriber", "ReplicaServer", "Snapshot",
           "SnapshotManager", "bucket_for", "quantize_decode_params",
           "retry_backoff_s", "serve_replica", "shape_buckets"]
