"""Optional device profiling (counterpart of
``rabbittclust_tpu/utils/profiling.py``): phase timers plus
``torch.profiler`` traces.

Set ``RTC_PROFILE_DIR=/path`` to capture a Chrome/Perfetto trace of every
engine phase that passes through ``maybe_trace``: one directory a phase,
``<RTC_PROFILE_DIR>/<phase with spaces as _>/``, each run adding one
``<host>_<pid>.<ns>.pt.trace.json`` there.  The traced phases are
``dense_mst_device_compact`` (``ops/engine.py::compute_mst_device``),
``bitmap_filter_cluster`` (``ops/cluster_fast.py::threshold_clusters_device``,
the stream engine) and ``labelprop_cluster``
(``ops/labelprop.py::threshold_clusters_device_lp``).  Host activity is
always traced; CUDA activity (the ``csrc/`` kernels by name, copies,
memsets) when the phase runs on a CUDA device.

Unset or empty: nothing is made and no profiler starts.  A profiler that
cannot start costs one line on stderr and the phase runs untraced.  An
exception raised by the traced phase reaches the caller as itself.

Where the card's clock drifts from the host's, Kineto drops the card's
records as out of its window in sessions that start long after the
process's first one (on an H100 host, from about 30 s on): a CLI run is
one process, so its traces hold its kernels, but a long-lived caller's
later traces may hold host activity only.
"""

from __future__ import annotations

import os
import socket
import sys
import time
from contextlib import contextmanager
from typing import Optional

import torch

ENV_VAR = "RTC_PROFILE_DIR"

# traces written by this process and the host seconds their profilers took
# to start, stop and export: a timer around a traced phase subtracts the
# growth of trace_s
TRACE_STATS = {"traces": 0, "trace_s": 0.0}


class Trace:
    """What ``maybe_trace`` yields: the JSON file written (None when the
    phase ran untraced) and the seconds the profiler's start, stop and
    export took (0.0 untraced)."""

    def __init__(self):
        self.path: Optional[str] = None
        self.seconds = 0.0


# Source: rabbittclust_tpu/utils/profiling.py::maybe_trace (over
# torch.profiler; the body's exception propagates unchanged)
@contextmanager
def maybe_trace(phase: str, device: Optional[torch.device] = None):
    out = os.environ.get(ENV_VAR)
    trace = Trace()
    if not out:
        yield trace
        return
    clock = time.perf_counter
    t0 = clock()
    trace_dir = os.path.join(out, phase.replace(" ", "_"))
    try:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device is not None and torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
    except Exception as e:  # no profiler on this build or host
        print(f"-----note: {ENV_VAR}: the profiler did not start for "
              f"{phase} ({type(e).__name__}: {e}); it runs untraced",
              file=sys.stderr)
        yield trace
        return
    _account(trace, clock() - t0)
    try:
        yield trace
    except BaseException:
        t0 = clock()
        try:
            prof.stop()
        except Exception:
            pass  # the body's own exception is the one to report
        _account(trace, clock() - t0)
        raise
    t0 = clock()
    prof.stop()
    path = os.path.join(trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    trace.path = path
    TRACE_STATS["traces"] += 1
    _account(trace, clock() - t0)


def _account(trace: Trace, seconds: float) -> None:
    trace.seconds += seconds
    TRACE_STATS["trace_s"] += seconds
