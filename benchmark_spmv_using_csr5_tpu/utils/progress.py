"""Progress hook for long-running host phases.

Large-matrix conversion, golden-model SpMV and device uploads can run for
minutes without output. Long phases call :func:`emit` at every milestone;
the benchmark case runner installs a sink that prints one flushed JSON
heartbeat line per event, so its log shows where a long case is (bench.py
skips lines carrying an ``hb`` key).

The default sink is a no-op, so library use stays silent.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

_sink: Optional[Callable[[str], None]] = None


def set_sink(sink: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with None) the process-wide heartbeat sink."""
    global _sink
    _sink = sink


def emit(phase: str) -> None:
    """Report liveness at a phase milestone (no-op without a sink)."""
    if _sink is not None:
        _sink(phase)


@contextlib.contextmanager
def phase(name: str):
    """Emit ``name`` on entry and ``name:done`` on exit."""
    emit(name)
    try:
        yield
    finally:
        emit(name + ":done")
