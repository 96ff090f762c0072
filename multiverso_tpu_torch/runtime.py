"""Process-wide session: one process on one explicit torch device, in a
group of processes or alone.

Counterpart of ``multiverso_tpu.runtime.Session``. This port runs one
device per process, so the session is flag parsing, the device choice,
the process group (``topology.init_group``: gloo on a TCPStore that rank 0
hosts, from ``MV_COORDINATOR_ADDRESS``/``MV_NUM_PROCESSES``/
``MV_PROCESS_ID`` or ``net_bind``/``net_connect``), the mesh over the
group's ranks (``topology.discover``: ``-mesh_shape``, by default one
worker per process), the table and serving registries, the process role
and the lifecycle. With a group, ``rank``/``size`` are the group's;
``num_workers``/``num_servers`` are the mesh's worker and server axes,
``local_workers`` is ``num_workers // size`` and ``worker_id`` is
``rank * local_workers`` (JAX ``runtime.py:345-404``: on the default
mesh, the rank); ``server_id`` is the rank; ``table_mesh`` is the mesh,
or this rank's (1, 1) mesh when the async bus runs. The worker axis must
divide by the process count (JAX ``runtime.py:90-96``), or, since a port
mesh holds one rank per process and so never more workers than
processes, the process count by the worker axis (each worker lane then
spans whole processes, its tp group); a mesh where neither holds is a
:class:`~.log.FatalError`. ``barrier()`` drains the async bus and then
rendezvouses, and
``aggregate`` sums every process's buffer with numpy in rank order, as
``np.sum(process_allgather(x), axis=0)`` does in the JAX package
(``multiverso_tpu/runtime.py:417-431``), so BSP sums carry the same bits.
Alone, rank and size are 0 and 1 and ``aggregate`` is the identity.

The device comes from ``-device`` (default ``cuda``). A CUDA request on a
host without a CUDA device is a :class:`~.log.FatalError`: the session
never carries on on the CPU unless the caller asked for the CPU.

As in ``multiverso_tpu/runtime.py:113-171``: ``-metrics_jsonl`` starts a
:class:`~.dashboard.MetricsExporter`; ``-wal`` opens the write-ahead delta
journal under the session's rank (``io/wal.DeltaWAL`` under ``-wal_dir``,
segments of ``-wal_segment_mb``, ``-wal_fsync``; its construction runs
torn-tail recovery); async mode (neither ``-sync`` nor ``-ma``) in a group
starts the delta bus (``parallel.async_ps.AsyncDeltaBus``);
``-failure_timeout_s`` > 0 in a group starts a
``parallel.health.FailureDetector`` whose watchdog declares silent peers
dead to the bus (survivor mode) or, without a bus, ends the process;
``-obs_plane`` runs an ``ObsAgent`` per process, rank 0 collecting over
the group's KV (alone: loopback, ``-obs_jsonl`` as given; in a group each
rank's archive gets its rank as a suffix).

``stop()`` follows ``multiverso_tpu/runtime.py:226-299``: the obs agent's
final report, the servers, the failure detector, the shutdown barrier (in
survivor mode among the live ranks only, through the store), the bus
(whose stop drains every delta in flight), the exit rendezvous and the
end of the group, the table flushes, the journal, the exporter.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from . import config, topology
from .dashboard import Dashboard
from .log import Log

# session-level flags whose features this port does not have yet: turning
# one on is an error, never a silent no-op
_UNPORTED_FLAGS = {"lockwatch": False}

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
        self.group: Optional[topology.ProcessGroup] = None  # >1 process
        self.topo: Optional[topology.Topology] = None  # the mesh
        self.async_bus: Optional[Any] = None  # cross-process async PS plane
        self.failure_detector: Optional[Any] = None  # -failure_timeout_s

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
            # the group forms before the session counts as started: a
            # group asked for that cannot form is fatal, never one process
            self.group = topology.init_group()
            try:
                self.topo = self._discover()
            except Exception:
                # every rank computes the same refusal: end the group
                # together, so that a later start can form a new one
                if self.group is not None:
                    self.group.close()
                    self.group = None
                raise
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
                    config.get_flag("wal_dir"), rank=self.rank,
                    segment_bytes=int(
                        config.get_flag("wal_segment_mb")) << 20,
                    fsync=config.get_flag("wal_fsync"))
            if self.group is not None:
                self.group.barrier("mv_init")
            from .parallel.async_ps import AsyncDeltaBus

            self.async_bus = AsyncDeltaBus.maybe_start(self)
            timeout = float(config.get_flag("failure_timeout_s"))
            if timeout > 0 and self.size > 1:
                from .parallel.health import FailureDetector

                self.failure_detector = FailureDetector(
                    interval_s=max(min(1.0, timeout / 5), 0.1), session=self)
                # survivor mode when the bus is up (dead peers leave its
                # ack quorum and training goes on); without a bus a dead
                # peer ends the process (BSP collectives cannot run short)
                self.failure_detector.start_watchdog(
                    timeout, self.async_bus.mark_dead
                    if self.async_bus is not None else None)
            if config.get_flag("obs_plane") and self.obs_agent is None:
                # one agent per process, rank 0 collecting over the
                # group's KV; alone, the agent is its own collector
                from .serving.obs_plane import ObsAgent

                sink = config.get_flag("obs_jsonl")
                if sink and self.size > 1:
                    sink = f"{sink}.{self.rank}"
                self.obs_agent = ObsAgent(
                    rank=self.rank, size=self.size, client=self.client,
                    report_ms=int(config.get_flag("obs_report_ms")),
                    sink=sink)
            Log.info("multiverso_tpu_torch initialised on %s: rank %d/%d, "
                     "mesh %s, mode %s", self.device, self.rank, self.size,
                     self.topo.mesh.shape,
                     "ma" if config.get_flag("ma")
                     else ("sync" if config.get_flag("sync") else "async"))
            return rest

    @staticmethod
    def _discover() -> topology.Topology:
        try:
            topo = topology.discover()
        except ValueError as exc:
            Log.fatal(f"-mesh_shape={config.get_flag('mesh_shape')}: {exc}")
        workers, size = topo.num_workers, topo.size
        if workers % size != 0 and size % workers != 0:
            Log.fatal(f"mesh worker axis ({workers}) must be a multiple of "
                      f"the process count ({size}) so every process owns "
                      f"the same number of worker lanes, or divide it so "
                      f"every lane spans the same number of processes; "
                      f"pass -mesh_shape to fix the layout")
        return topo

    def stop(self, finalize: bool = True) -> None:
        """``MV_ShutDown``, in ``multiverso_tpu/runtime.py:226-299``'s
        order (module docstring). The state is claimed under the lock and
        torn down outside it. ``finalize`` is the reference's ask to
        finalize the message-passing layer as well; the group always ends
        here, so it changes nothing, as in the JAX package."""
        with self._lock:
            if not self.started:
                return
            self.started = False
            servers, self.servers = self.servers, []
            exporter, self.metrics_exporter = self.metrics_exporter, None
            obs, self.obs_agent = self.obs_agent, None
            wal, self.wal = self.wal, None
            group, self.group = self.group, None
            self.topo = None
            bus, self.async_bus = self.async_bus, None
            detector, self.failure_detector = self.failure_detector, None
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
        if detector is not None:
            detector.stop()
        live = None
        if group is not None:
            if bus is not None and bus._survivor_mode:
                # survivor mode: always the live-set barrier through the
                # store (a survivor whose watchdog has not fired yet would
                # otherwise take the gloo barrier while its peers take the
                # live one); _live_ranks unions the KV declarations so the
                # survivors agree on the list
                live = bus._live_ranks()
            group.barrier("mv_shutdown", live)
        if bus is not None:
            # collective: every delta in flight lands everywhere before
            # any table is torn down (the reference's FinishTrain drain);
            # the registry stays up until then, for the drain's applies
            bus.stop()
            if bus._survivor_mode:
                live = [r for r in range(group.size) if r not in bus._dead]
        if group is not None:
            group.close(live)
        with self._lock:
            tables, self.tables = self.tables, []
        for table in tables:
            table.flush()
        if wal is not None:
            # after the table flushes: no apply path can append anymore
            # (the session's journal was detached when the state was
            # claimed, and the bus has stopped)
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
    def client(self) -> Optional[topology.StoreKV]:
        """The group's coordination KV (None alone)."""
        return self.group.client if self.group is not None else None

    @property
    def rank(self) -> int:
        self._require_started()
        return self.group.rank if self.group is not None else 0

    @property
    def size(self) -> int:
        self._require_started()
        return self.group.size if self.group is not None else 1

    def barrier(self) -> None:
        """``MV_Barrier``. With the async bus it first drains the bus, so
        barrier-separated phases see each other's adds."""
        self._require_started()
        if self.async_bus is not None:
            self.async_bus.drain("barrier")
            if self.async_bus._dead:
                # survivor mode: the drain's live-set barriers were the
                # rendezvous; a gloo barrier would wait on the dead peer
                return
        if self.group is not None:
            self.group.barrier()

    @property
    def mesh(self) -> topology.Mesh:
        self._require_started()
        return self.topo.mesh

    @property
    def table_mesh(self) -> topology.Mesh:
        """The mesh tables live on: the session's, or with the async bus
        this rank's (1, 1) mesh (each process updates its own replica
        without collectives; the bus carries the deltas)."""
        self._require_started()
        if self.async_bus is not None:
            return self.topo.local_mesh
        return self.topo.mesh

    @property
    def num_workers(self) -> int:
        """The worker-id space: the mesh's worker axis (one worker per
        process on the default mesh)."""
        self._require_started()
        return self.topo.num_workers

    @property
    def local_workers(self) -> int:
        """Worker lanes this process owns (``num_workers // size``: 0 where
        a lane spans several processes)."""
        self._require_started()
        return self.topo.num_workers // self.topo.size

    @property
    def num_servers(self) -> int:
        """The mesh's server axis (1 on the default mesh)."""
        self._require_started()
        return self.topo.num_servers

    @property
    def worker_id(self) -> int:
        """This process's first worker lane (the rank on the default
        mesh)."""
        self._require_started()
        if not (self.role & _ROLE_WORKER):
            return -1
        return self.topo.rank * self.local_workers

    @property
    def server_id(self) -> int:
        return self.rank if self.role & _ROLE_SERVER else -1

    def is_worker(self) -> bool:
        return bool(self.role & _ROLE_WORKER)

    def is_server(self) -> bool:
        return bool(self.role & _ROLE_SERVER)

    def aggregate(self, data: np.ndarray) -> np.ndarray:
        """``MV_Aggregate``: the in-place sum of a host buffer over every
        process, summed with numpy in rank order (the identity alone)."""
        self._require_started()
        if self.group is None:
            return data
        gathered = self.group.allgather(np.asarray(data))
        np.copyto(data, np.sum(gathered, axis=0).astype(data.dtype))
        return data
