"""Serving subsystem of the PyTorch port: the continuous-batching decode
engine behind an in-process :class:`InferenceServer`."""

from .batcher import (DeadlineExceededError, OverloadedError, bucket_for,
                      shape_buckets)
from .decode_engine import DecodeEngine, DecodeEngineConfig
from .server import InferenceServer
from .snapshot import Snapshot, SnapshotManager

__all__ = ["DeadlineExceededError", "DecodeEngine", "DecodeEngineConfig",
           "InferenceServer", "OverloadedError", "Snapshot",
           "SnapshotManager", "bucket_for", "shape_buckets"]
