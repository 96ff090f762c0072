"""multiverso_tpu_torch: the PyTorch / CUDA port of multiverso-tpu.

A second package beside ``multiverso_tpu`` (the JAX reference, which it
never imports). Module names mirror the JAX package's. Entry points run on
the CUDA device unless the caller asks for the CPU with ``-device=cpu``.

Top-level functions mirror ``multiverso_tpu/__init__.py``: ``init`` /
``shutdown`` / ``barrier`` / ``rank`` / ``size`` / ``num_workers`` /
``num_servers`` / ``worker_id`` / ``server_id`` / ``is_worker`` /
``is_server`` / ``aggregate`` / ``session``, plus ``create_table`` for the
``array``, ``matrix``, ``kv``, ``sparse`` and ``ftrl`` tables, and
``net_bind`` / ``net_connect`` (``topology``) to name a process group
explicitly instead of through ``MV_COORDINATOR_ADDRESS``,
``MV_NUM_PROCESSES`` and ``MV_PROCESS_ID``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from . import config, trace
from .config import (define_bool, define_float, define_int, define_string,
                     get_flag, parse_cmd_flags, set_flag)
from .dashboard import (Counter, Dashboard, Gauge, Histogram, Monitor,
                        monitor, profile_trace)
from .log import FatalError, Log, LogLevel, check, check_notnull
from .runtime import Session
from .topology import net_bind, net_connect

__version__ = "0.1.0"


def init(argv: Optional[Sequence[str]] = None, sync: Optional[bool] = None,
         updater: Optional[str] = None, **flags: Any) -> List[str]:
    """Initialise the process (``MV_Init``); ``-device=cuda|cpu`` picks the
    device. ``sync`` sets ``-sync`` and ``updater`` ``-updater_type``, as
    in the JAX package."""
    if sync is not None:
        set_flag("sync", bool(sync))
    if updater is not None:
        set_flag("updater_type", updater)
    for key, value in flags.items():
        set_flag(key, value)
    return Session.get().start(argv)


def shutdown(finalize: bool = True) -> None:
    """``MV_ShutDown``."""
    Session.get().stop(finalize)


def barrier() -> None:
    Session.get().barrier()


def rank() -> int:
    return Session.get().rank


def size() -> int:
    return Session.get().size


def session() -> Session:
    return Session.get()


def num_workers() -> int:
    return Session.get().num_workers


def num_servers() -> int:
    return Session.get().num_servers


def worker_id() -> int:
    return Session.get().worker_id


def server_id() -> int:
    return Session.get().server_id


def is_worker() -> bool:
    return Session.get().is_worker()


def is_server() -> bool:
    return Session.get().is_server()


def aggregate(data):
    """``MV_Aggregate``: the in-place sum of a host buffer over the group
    (the identity in one process)."""
    return Session.get().aggregate(data)


def create_table(kind: str, *args: Any, **kwargs: Any):
    """``MV_CreateTable`` factory: ``kind`` is one of ``array`` /
    ``matrix`` / ``kv`` / ``sparse`` / ``ftrl``, with the JAX package's
    arguments (and ``device=`` on the device tables)."""
    from . import tables

    factory = {"array": tables.ArrayTable, "matrix": tables.MatrixTable,
               "kv": tables.KVTable, "sparse": tables.SparseTable,
               "ftrl": tables.FTRLTable}
    try:
        cls = factory[kind]
    except KeyError:
        Log.fatal(f"unknown table kind {kind!r}; expected one of "
                  f"{sorted(factory)}")
    table = cls(*args, **kwargs)
    barrier()  # MV_CreateTable barriers after creation
    return table
