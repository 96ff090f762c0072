"""Serving subsystem of the PyTorch port: micro-batched workloads and the
continuous-batching decode engine behind an in-process
:class:`InferenceServer`."""

from .batcher import (BatcherConfig, DeadlineExceededError, MicroBatcher,
                      OverloadedError, bucket_for, shape_buckets)
from .decode_engine import DecodeEngine, DecodeEngineConfig
from .server import InferenceServer
from .snapshot import (DerivedCache, Snapshot, SnapshotManager,
                       quantize_decode_params)
from .workloads import EmbeddingNeighbors, LMGreedyDecode

__all__ = ["BatcherConfig", "DeadlineExceededError", "DecodeEngine",
           "DecodeEngineConfig", "DerivedCache", "EmbeddingNeighbors",
           "InferenceServer", "LMGreedyDecode", "MicroBatcher",
           "OverloadedError", "Snapshot", "SnapshotManager", "bucket_for",
           "quantize_decode_params", "shape_buckets"]
