"""Process-wide session: one process on one explicit torch device.

Counterpart of ``multiverso_tpu.runtime.Session`` and
``multiverso_tpu.topology`` for the PyTorch port. The JAX session
discovers a device mesh; this port runs one process on one device, so
the session reduces to flag parsing, the device choice, the table and
serving registries, the process role and lifecycle. Rank and size are 0
and 1, there is one worker and one server, the barrier is a no-op and
``aggregate`` is the identity until the distributed paths are ported.

The device comes from ``-device`` (default ``cuda``). A CUDA request on a
host without a CUDA device is a :class:`~.log.FatalError`: the session
never carries on on the CPU unless the caller asked for the CPU.

``-metrics_jsonl`` starts a :class:`~.dashboard.MetricsExporter` and
``-obs_plane`` an :class:`~.serving.obs_plane.ObsAgent` (in loopback: one
process is its own collector), as ``multiverso_tpu/runtime.py:113-121,
155-171`` does; at ``stop()`` the agent ships its final report before
the servers stop, and the exporter its final line last. ``-wal`` opens
the write-ahead delta journal (``io/wal.DeltaWAL`` under ``-wal_dir``,
rank 0, segments of ``-wal_segment_mb``, ``-wal_fsync``; its construction
runs torn-tail recovery) as ``multiverso_tpu/runtime.py:123-136`` does,
and ``stop()`` closes it after the table flushes (JAX :291-294).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from . import config
from .dashboard import Dashboard
from .log import Log

# session-level flags whose features this port does not have yet: turning
# one on is an error, never a silent no-op
_UNPORTED_FLAGS = {"lockwatch": False, "failure_timeout_s": 0.0,
                   "mesh_shape": ""}

_ROLE_NONE, _ROLE_WORKER, _ROLE_SERVER, _ROLE_ALL = 0, 1, 2, 3
_ROLES = {"none": _ROLE_NONE, "worker": _ROLE_WORKER,
          "server": _ROLE_SERVER, "default": _ROLE_ALL, "all": _ROLE_ALL}


def resolve_device(name: str) -> torch.device:
    """``-device`` text -> ``torch.device``; raises when CUDA is asked for
    and absent."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            Log.fatal("-device=cuda but torch.cuda.is_available() is False; "
                      "pass -device=cpu to run on the CPU")
    elif dev.type != "cpu":
        Log.fatal(f"-device must be 'cuda' or 'cpu', got {name!r}")
    return dev


class Session:
    """Singleton runtime state (the reference ``Zoo::Get()`` analogue)."""

    _instance: Optional["Session"] = None
    _lock = threading.RLock()

    def __init__(self) -> None:
        self.device: Optional[torch.device] = None
        self.tables: List[Any] = []   # parameter tables, by table id
        self.servers: List[Any] = []  # serving.InferenceServer registry
        self.role: int = _ROLE_ALL
        self.started = False
        self.metrics_exporter: Optional[Any] = None  # -metrics_jsonl
        self.obs_agent: Optional[Any] = None  # -obs_plane fleet agent
        self.wal: Optional[Any] = None  # -wal write-ahead delta journal

    @classmethod
    def get(cls) -> "Session":
        with cls._lock:
            if cls._instance is None:
                cls._instance = Session()
            return cls._instance

    def start(self, argv: Optional[Sequence[str]] = None) -> List[str]:
        with self._lock:
            rest = config.parse_cmd_flags(list(argv) if argv else None)
            Log.reset_log_level_by_name(config.get_flag("log_level"))
            log_file = config.get_flag("log_file")
            if log_file:
                Log.reset_log_file(log_file)
            if self.started:
                return rest
            for flag, off in _UNPORTED_FLAGS.items():
                if config.get_flag(flag) != off:
                    Log.fatal(f"-{flag} is not ported to multiverso_tpu_torch "
                              f"yet (got {config.get_flag(flag)!r})")
            self.device = resolve_device(config.get_flag("device"))
            self.role = _ROLES.get(config.get_flag("ps_role"), _ROLE_ALL)
            if config.get_flag("trace"):
                from . import trace

                if not trace.enabled():
                    tail = None
                    if config.get_flag("trace_tail"):
                        tail = trace.TailConfig(
                            slo_ms=float(config.get_flag("trace_slo_ms")),
                            head_n=int(config.get_flag("trace_head_n")))
                    trace.enable(int(config.get_flag("trace_buffer")),
                                 tail=tail)
            if config.get_flag("wal") and not config.get_flag("wal_dir"):
                Log.fatal("-wal=true requires -wal_dir=PATH (the journal "
                          "must land somewhere durable)")
            self.started = True
            metrics_path = config.get_flag("metrics_jsonl")
            if metrics_path and self.metrics_exporter is None:
                from .dashboard import MetricsExporter

                self.metrics_exporter = MetricsExporter(
                    interval_s=float(config.get_flag("metrics_interval_s")),
                    sink=metrics_path).start()
            if config.get_flag("wal") and self.wal is None:
                from .io.wal import DeltaWAL

                # construction runs torn-tail recovery and opens a fresh
                # segment for this incarnation
                self.wal = DeltaWAL(
                    config.get_flag("wal_dir"), rank=0,
                    segment_bytes=int(
                        config.get_flag("wal_segment_mb")) << 20,
                    fsync=config.get_flag("wal_fsync"))
            if config.get_flag("obs_plane") and self.obs_agent is None:
                # one process: the agent is its own collector (loopback,
                # no sockets, no coordination client)
                from .serving.obs_plane import ObsAgent

                self.obs_agent = ObsAgent(
                    rank=0, size=1, client=None,
                    report_ms=int(config.get_flag("obs_report_ms")),
                    sink=config.get_flag("obs_jsonl"))
            Log.info("multiverso_tpu_torch initialised on %s", self.device)
            return rest

    def stop(self, finalize: bool = True) -> None:
        """``MV_ShutDown``. ``finalize`` is the reference's ask to finalize
        the message-passing layer as well; one process has none, so it is
        accepted, as the JAX package accepts it, and changes nothing."""
        with self._lock:
            if not self.started:
                return
            self.started = False
            servers, self.servers = self.servers, []
            tables, self.tables = self.tables, []
            exporter, self.metrics_exporter = self.metrics_exporter, None
            obs, self.obs_agent = self.obs_agent, None
            wal, self.wal = self.wal, None
        # the obs agent ships its final report first, while the engines it
        # summarizes are still alive to be read
        if obs is not None:
            try:
                obs.stop(final_report=True)
            except Exception as exc:
                Log.error("obs plane shutdown failed: %s", exc)
        # serving drains next: in-flight replies read tables
        for srv in servers:
            try:
                srv.stop()
            except Exception as exc:
                Log.error("serving shutdown failed: %s", exc)
        for table in tables:
            table.flush()
        if wal is not None:
            # after the table flushes: no apply path can append anymore
            # (the registry was emptied when the state was claimed)
            wal.close()
        if exporter is not None:
            # the shutdown snapshot lands in the JSON-lines archive
            exporter.stop(final_report=True)
        Dashboard.display()

    def register_table(self, table: Any) -> int:
        """Assign the next table id (``Zoo::RegisterTable``)."""
        with self._lock:
            self._require_started()
            self.tables.append(table)
            return len(self.tables) - 1

    def table(self, table_id: int) -> Any:
        return self.tables[table_id]

    def register_server(self, server: Any) -> None:
        with self._lock:
            self._require_started()
            self.servers.append(server)

    def _require_started(self) -> None:
        if not self.started:
            Log.fatal("multiverso_tpu_torch session not initialised; "
                      "call init() first")

    @property
    def rank(self) -> int:
        self._require_started()
        return 0

    @property
    def size(self) -> int:
        self._require_started()
        return 1

    def barrier(self) -> None:
        self._require_started()

    @property
    def num_workers(self) -> int:
        self._require_started()
        return 1

    @property
    def num_servers(self) -> int:
        self._require_started()
        return 1

    @property
    def worker_id(self) -> int:
        self._require_started()
        return 0 if self.role & _ROLE_WORKER else -1

    @property
    def server_id(self) -> int:
        self._require_started()
        return 0 if self.role & _ROLE_SERVER else -1

    def is_worker(self) -> bool:
        return bool(self.role & _ROLE_WORKER)

    def is_server(self) -> bool:
        return bool(self.role & _ROLE_SERVER)

    def aggregate(self, data: np.ndarray) -> np.ndarray:
        """``MV_Aggregate``: the in-place sum of a host buffer over all
        processes, which is the buffer itself in one process."""
        self._require_started()
        return data
