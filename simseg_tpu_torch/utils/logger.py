"""Leveled, rank-0-gated logger on Python's ``logging`` (port of
``simseg_tpu/utils/logger.py``).

Parity: reference ``simseg/utils/logger.py:55-139`` — levels DEBUG / INFO /
EMPH (25) / WARNING / ERROR / FATAL, the caller's ``file:line`` in every
line, output on rank 0 only unless ``root_only=False``, and an optional
rank-0 file sink (``set_file``). It is the ``logging`` logger ``simseg``
with a handler of its own on standard output (no propagation), so it
leaves the port's module loggers and the root logger's handlers as they
are. ``SIMSEG_LOG_LEVEL`` sets the starting level, as in JAX.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any

from simseg_tpu_torch.utils.context import ENV

EMPH = 25
logging.addLevelName(EMPH, "EMPH")
_LEVELS = {"DEBUG": logging.DEBUG, "INFO": logging.INFO, "EMPH": EMPH,
           "WARNING": logging.WARNING, "ERROR": logging.ERROR,
           "FATAL": logging.CRITICAL}
_FORMAT = "[%(asctime)s][%(levelname)s][%(filename)s:%(lineno)d] %(message)s"


class _RootOnly(logging.Filter):
    """Drops a record marked ``root_only`` on a rank other than 0."""

    def filter(self, record: logging.LogRecord) -> bool:
        return not getattr(record, "root_only", True) or ENV.rank == 0


class Logger:
    def __init__(self, name: str = "simseg") -> None:
        self._logger = logging.getLogger(name)
        self._logger.propagate = False
        self._logger.setLevel(_LEVELS.get(
            os.environ.get("SIMSEG_LOG_LEVEL", "INFO").upper(), logging.INFO))
        if not self._logger.handlers:
            self._add(logging.StreamHandler(sys.stdout))

    @property
    def level(self) -> int:
        return self._logger.level

    def _add(self, handler: logging.Handler) -> None:
        handler.setFormatter(logging.Formatter(_FORMAT, "%Y-%m-%d %H:%M:%S"))
        handler.addFilter(_RootOnly())
        self._logger.addHandler(handler)

    def set_level(self, level: str) -> None:
        self._logger.setLevel(_LEVELS[level.upper()])

    def set_file(self, path: str) -> None:
        """A file sink on rank 0 (parity: logger.py:41-52)."""
        if ENV.rank != 0:
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._add(logging.FileHandler(path))

    def _log(self, level: str, args, root_only: bool) -> None:
        # stacklevel 3: the caller of debug() / info() / ... names the line
        self._logger.log(_LEVELS[level], " ".join(str(a) for a in args),
                         stacklevel=3, extra={"root_only": root_only})

    def debug(self, *args: Any, root_only: bool = True) -> None:
        self._log("DEBUG", args, root_only)

    def info(self, *args: Any, root_only: bool = True) -> None:
        self._log("INFO", args, root_only)

    def emph(self, *args: Any, root_only: bool = True) -> None:
        self._log("EMPH", args, root_only)

    def warning(self, *args: Any, root_only: bool = True) -> None:
        self._log("WARNING", args, root_only)

    def error(self, *args: Any, root_only: bool = True) -> None:
        self._log("ERROR", args, root_only)

    def fatal(self, *args: Any, root_only: bool = True) -> None:
        self._log("FATAL", args, root_only)
        raise SystemExit(1)


logger = Logger()
