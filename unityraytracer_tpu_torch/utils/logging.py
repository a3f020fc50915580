"""Leveled file logger (the RayTraceDebug.Log analog, RayTraceDebug.cs:19-36).

Levels mirror the reference: 0 NONE, 1 WARNING, 2 BASIC, 3 DETAILED
(RayTraceDebug.cs:8). Each logger writes to ``<dir>/<name>.txt`` with a
timestamped run header, plus optional stderr echo.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

NONE, WARNING, BASIC, DETAILED = 0, 1, 2, 3
_LEVEL_NAMES = {NONE: "NONE", WARNING: "WARN", BASIC: "BASIC", DETAILED: "DETAIL"}


class DebugLog:
    """Append-only leveled logger."""

    def __init__(self, name: str = "log", directory: str = "Debug",
                 level: int = BASIC, echo: bool = False):
        self.level = level
        self.echo = echo
        self._fh = None
        if level > NONE:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, f"{name}.txt")
            self._fh = open(path, "a")
            header = (f"\n=== run {time.strftime('%Y-%m-%d %H:%M:%S')} "
                      f"level={_LEVEL_NAMES[level]} ===\n")
            self._fh.write(header)
            self._fh.flush()
            self.path = path

    def log(self, text: str, level: int = BASIC) -> None:
        if self._fh is None or level > self.level or level == NONE:
            return
        line = f"[{time.strftime('%H:%M:%S')}][{_LEVEL_NAMES.get(level, '?')}] {text}\n"
        self._fh.write(line)
        self._fh.flush()
        if self.echo:
            sys.stderr.write(line)

    def warn(self, text: str) -> None:
        self.log(text, WARNING)

    def detail(self, text: str) -> None:
        self.log(text, DETAILED)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


_default: Optional[DebugLog] = None


def get_logger() -> DebugLog:
    global _default
    if _default is None:
        _default = DebugLog(level=NONE)  # silent unless configured
    return _default


def configure(name: str = "log", directory: str = "Debug",
              level: int = BASIC, echo: bool = False) -> DebugLog:
    global _default
    if _default is not None:
        _default.close()
    _default = DebugLog(name, directory, level, echo)
    return _default
