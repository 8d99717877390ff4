"""Phase wall-time tracing (reference common.hpp:28-33 Timer macro)."""

from __future__ import annotations

import sys
from contextlib import contextmanager
from typing import Optional

from .profiling import span


# Source: rabbittclust_tpu/utils/timers.py::Timer (each phase a span)
class Timer:
    """Accumulates named phase times; prints reference-style stderr lines.
    A phase is the span ``span_name`` (default: the phase's name)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases = {}

    @contextmanager
    def phase(self, name: str, span_name: Optional[str] = None):
        sp = span(span_name or name)
        try:
            with sp:
                yield
        finally:
            dt = sp.seconds
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if self.enabled:
                print(f"===================time of {name} is: {dt:.6f}",
                      file=sys.stderr)
