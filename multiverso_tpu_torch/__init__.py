"""multiverso_tpu_torch: the PyTorch / CUDA port of multiverso-tpu.

A second package beside ``multiverso_tpu`` (the JAX reference, which it
never imports). Module names mirror the JAX package's. Entry points run on
the CUDA device unless the caller asks for the CPU with ``-device=cpu``.

Top-level functions mirror ``multiverso_tpu/__init__.py``: ``init`` /
``shutdown`` / ``barrier`` / ``rank`` / ``size`` / ``session``.
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

__version__ = "0.1.0"


def init(argv: Optional[Sequence[str]] = None, **flags: Any) -> List[str]:
    """Initialise the process; ``-device=cuda|cpu`` picks the device."""
    for key, value in flags.items():
        set_flag(key, value)
    return Session.get().start(argv)


def shutdown() -> None:
    Session.get().stop()


def barrier() -> None:
    Session.get().barrier()


def rank() -> int:
    return Session.get().rank


def size() -> int:
    return Session.get().size


def session() -> Session:
    return Session.get()

