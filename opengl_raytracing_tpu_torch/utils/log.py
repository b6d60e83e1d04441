"""Structured logger with the reference's event taxonomy.

A copy of `opengl_raytracing_tpu/utils/log.py`.  Mirrors `ui::Log`
which mirrors printf-style messages to stdout and an in-app console
(reference: src/ui/gui.cpp:131-145); subsystem prefixes
[INIT] [ENV] [BVH] [GUI] [LIGHT] [TAA] [SVGF] [ACCUM] [INPUT] follow the
reference's usage (e.g. src/app/application.cpp:235,299,491,548).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, List, Optional

KNOWN_TAGS = ("INIT", "ENV", "BVH", "GUI", "LIGHT", "TAA", "SVGF", "ACCUM",
              "INPUT", "BENCH", "CKPT", "MESH", "PAR")


class Logger:
    """Scrollback console with filter, like the reference DebugConsole
    (reference: src/ui/gui.cpp:16-104)."""

    def __init__(self, stream=None, echo: bool = True):
        self.lines: List[str] = []
        self.stream = stream if stream is not None else sys.stdout
        self.echo = echo
        self._t0 = time.monotonic()
        self.sinks: List[Callable[[str], None]] = []

    def log(self, tag: str, fmt: str, *args) -> str:
        msg = fmt % args if args else fmt
        line = f"[{tag}] {msg}"
        self.lines.append(line)
        if self.echo:
            print(line, file=self.stream)
        for sink in self.sinks:
            sink(line)
        return line

    def filtered(self, needle: Optional[str] = None) -> List[str]:
        if not needle:
            return list(self.lines)
        return [ln for ln in self.lines if needle in ln]

    def clear(self) -> None:
        self.lines.clear()


_default = Logger()


def log(tag: str, fmt: str, *args) -> str:
    return _default.log(tag, fmt, *args)


def default_logger() -> Logger:
    return _default
