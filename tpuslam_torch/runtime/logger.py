"""Leveled logger with in-memory buffer and log.txt flush.

A copy of tpuslam/runtime/logger.py (pure Python).  Twin of the
reference's src/slam/src/core/Logger.cpp: DEBUG/INFO/WARN/
ERROR levels with file:line prefixes, `-quiet` suppression of console
output, a mutex-guarded in-memory message buffer flushed to `log.txt` at
shutdown (Logger.cpp:58-68).

One deliberate divergence (SURVEY.md §5): the reference's LOG_ERROR
halts in an infinite loop (Logger.cpp:53-55); here errors raise a
structured `SlamError` so callers can checkpoint and recover.
"""

from __future__ import annotations

import inspect
import os
import threading
import time

LOG_LEVEL_DEBUG = 0
LOG_LEVEL_INFO = 1
LOG_LEVEL_WARN = 2
LOG_LEVEL_ERROR = 3

_LEVEL_NAMES = {0: "DEBUG", 1: "INFO", 2: "WARN", 3: "ERROR"}


class SlamError(RuntimeError):
    """Structured fatal error (replaces the reference's halt-forever)."""


class Logger:
    def __init__(self, level: int = LOG_LEVEL_INFO, quiet: bool = False):
        self.level = level
        self.quiet = quiet
        self._buffer: list[str] = []
        self._mutex = threading.Lock()
        self._t0 = time.monotonic()

    def _write(self, level: int, msg: str, stacklevel: int = 3):
        if level < self.level:
            return
        frame = inspect.stack()[stacklevel - 1]
        loc = f"{os.path.basename(frame.filename)}:{frame.lineno}"
        t_ms = (time.monotonic() - self._t0) * 1000.0
        line = f"[{_LEVEL_NAMES[level]}] {t_ms:10.1f} {loc} {msg}"
        with self._mutex:
            self._buffer.append(line)
            if not self.quiet:
                print(line, flush=True)
        if level == LOG_LEVEL_ERROR:
            self.flush("log.txt")
            raise SlamError(f"{loc}: {msg}")

    def debug(self, msg: str):
        self._write(LOG_LEVEL_DEBUG, msg)

    def info(self, msg: str):
        self._write(LOG_LEVEL_INFO, msg)

    def warn(self, msg: str):
        self._write(LOG_LEVEL_WARN, msg)

    def error(self, msg: str):
        self._write(LOG_LEVEL_ERROR, msg)

    def flush(self, path: str = "log.txt"):
        """Write the buffered messages (Logger::writeToLogFile)."""
        with self._mutex:
            with open(path, "w") as f:
                f.write("\n".join(self._buffer))
                if self._buffer:
                    f.write("\n")


# global logger, mirroring the reference's `Logger logger` singleton
logger = Logger()


def log_debug(msg: str):
    logger._write(LOG_LEVEL_DEBUG, msg)


def log_info(msg: str):
    logger._write(LOG_LEVEL_INFO, msg)


def log_warn(msg: str):
    logger._write(LOG_LEVEL_WARN, msg)


def log_error(msg: str):
    logger._write(LOG_LEVEL_ERROR, msg)
