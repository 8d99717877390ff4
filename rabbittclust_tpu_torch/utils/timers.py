"""Phase wall-time tracing (reference common.hpp:28-33 Timer macro)."""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager


# Source: rabbittclust_tpu/utils/timers.py::Timer
class Timer:
    """Accumulates named phase times; prints reference-style stderr lines."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if self.enabled:
                print(f"===================time of {name} is: {dt:.6f}",
                      file=sys.stderr)
