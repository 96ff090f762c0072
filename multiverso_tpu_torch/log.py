"""Logging with Debug/Info/Error/Fatal levels + CHECK helpers.

PyTorch-port copy of ``multiverso_tpu.log``, the equivalent of the reference logger
(``include/multiverso/util/log.h:9-18,110-142`` in the Multiverso reference):
timestamped ``[LEVEL] [ts] [rank]`` lines to stdout plus an optional file sink,
a ``Fatal`` level that (by default) raises instead of killing the process, and
``CHECK`` / ``CHECK_NOTNULL`` assertion helpers that route through ``Fatal``.

Built on the stdlib ``logging`` module rather than a hand-rolled sink so user
code can attach handlers; the reference-facing API surface is preserved. The
stdlib logger is the port's own (``multiverso_tpu_torch``): in a process that
imports both packages, the port's level and file sink leave the JAX package's
``multiverso`` logger alone.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from enum import IntEnum
from typing import Any, Optional


class LogLevel(IntEnum):
    DEBUG = 0
    INFO = 1
    ERROR = 2
    FATAL = 3


_LEVEL_MAP = {
    LogLevel.DEBUG: logging.DEBUG,
    LogLevel.INFO: logging.INFO,
    LogLevel.ERROR: logging.ERROR,
    LogLevel.FATAL: logging.CRITICAL,
}

_LEVEL_NAMES = {"debug": LogLevel.DEBUG, "info": LogLevel.INFO,
                "error": LogLevel.ERROR, "fatal": LogLevel.FATAL}


class FatalError(RuntimeError):
    """Raised by Log.fatal / failed CHECKs when kill-on-fatal is off."""


class Logger:
    """Instance logger; static facade below mirrors the reference's ``Log``."""

    def __init__(self, name: str = "multiverso_tpu_torch",
                 level: LogLevel = LogLevel.INFO) -> None:
        self._logger = logging.getLogger(name)
        self._logger.propagate = False
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(self._formatter())
            self._logger.addHandler(handler)
        self._level = level
        self._logger.setLevel(_LEVEL_MAP[level])
        self._kill_fatal = False
        self._file_handler: Optional[logging.Handler] = None
        self._lock = threading.Lock()

    @staticmethod
    def _formatter() -> logging.Formatter:
        return logging.Formatter(
            "[%(levelname)s] [%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
        )

    # -- configuration ----------------------------------------------------
    def reset_log_level(self, level: LogLevel) -> None:
        self._level = level
        self._logger.setLevel(_LEVEL_MAP[level])

    def reset_log_file(self, path: str) -> None:
        with self._lock:
            if self._file_handler is not None:
                self._logger.removeHandler(self._file_handler)
                self._file_handler.close()
                self._file_handler = None
            if path:
                handler = logging.FileHandler(path)
                handler.setFormatter(self._formatter())
                self._logger.addHandler(handler)
                self._file_handler = handler

    def reset_kill_fatal(self, kill: bool) -> None:
        self._kill_fatal = kill

    @property
    def level(self) -> LogLevel:
        return self._level

    # -- emission ---------------------------------------------------------
    def debug(self, msg: str, *args: Any) -> None:
        self._logger.debug(msg, *args)

    def info(self, msg: str, *args: Any) -> None:
        self._logger.info(msg, *args)

    def error(self, msg: str, *args: Any) -> None:
        self._logger.error(msg, *args)

    def fatal(self, msg: str, *args: Any) -> None:
        rendered = msg % args if args else msg
        self._logger.critical(rendered)
        if self._kill_fatal:
            if threading.current_thread() is threading.main_thread():
                sys.exit(1)
            # sys.exit in a worker thread raises SystemExit that threading
            # swallows — the process would keep training past a fatal
            # invariant violation. Kill for real (message already flushed
            # through the critical handler above).
            os._exit(1)
        raise FatalError(rendered)


_LOGGER = Logger()


class Log:
    """Static facade (reference ``Log::Info`` etc.)."""

    @staticmethod
    def logger() -> Logger:
        return _LOGGER

    @staticmethod
    def reset_log_level(level: LogLevel) -> None:
        _LOGGER.reset_log_level(level)

    @staticmethod
    def reset_log_level_by_name(name: str) -> None:
        _LOGGER.reset_log_level(_LEVEL_NAMES.get(name.lower(), LogLevel.INFO))

    @staticmethod
    def reset_log_file(path: str) -> None:
        _LOGGER.reset_log_file(path)

    @staticmethod
    def reset_kill_fatal(kill: bool) -> None:
        _LOGGER.reset_kill_fatal(kill)

    @staticmethod
    def debug(msg: str, *args: Any) -> None:
        _LOGGER.debug(msg, *args)

    @staticmethod
    def info(msg: str, *args: Any) -> None:
        _LOGGER.info(msg, *args)

    @staticmethod
    def error(msg: str, *args: Any) -> None:
        _LOGGER.error(msg, *args)

    @staticmethod
    def fatal(msg: str, *args: Any) -> None:
        _LOGGER.fatal(msg, *args)


def check(condition: bool, msg: str = "CHECK failed") -> None:
    """Reference ``CHECK`` macro (``log.h:9-13``)."""
    if not condition:
        Log.fatal(msg)


def check_notnull(value: Any, name: str = "value") -> Any:
    """Reference ``CHECK_NOTNULL`` macro (``log.h:15-18``)."""
    if value is None:
        Log.fatal(f"{name} must not be None")
    return value
