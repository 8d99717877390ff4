"""The port's tracing: spans, counters, the job scope, CUDA-event timers
and ``torch.profiler`` traces (the last the counterpart of
``rabbittclust_tpu/utils/profiling.py``).

Spans.  ``with span(name) as sp:`` times its body with
``time.perf_counter_ns`` into ``sp.seconds``, and adds them to
``stats[key]`` when given ``stats`` and ``key`` (the engines' ``LP_STATS``
and ``stats`` keys are filled so).  Inside a job scope it also records
(span id, parent id, job id, name, start ns, end ns) in the job's list,
in memory.  Only while a ``torch.profiler`` session is on does it open
``torch.profiler.record_function(name)``, so the span shows in the Chrome
trace as a ``user_annotation`` range on the kernels' clock; with neither a
job nor a profiler it costs two clock reads and the profiler's flag.
``count(name, n)`` adds to the open job's counters, and does nothing
without one.

The job scope.  ``job(stats)`` opens the root span ``job`` under a fresh
job id; on exit it writes ``stats["spans"]`` (``{name: {"n", "total_s",
"self_s"}}``, self time being a span's duration less what its child spans
cover) and ``stats["counters"]`` (``{name: value}``).  Without ``stats``
it is the plain span ``job``.  ``workflows.compute_kssd_clusters`` opens
one a call.

``EventTimer`` sums the device milliseconds of the calls it wraps (CUDA
events; nothing elsewhere).

Traces.  Set ``RTC_PROFILE_DIR=/path`` to capture a Chrome/Perfetto trace
of every engine phase that passes through ``maybe_trace``: one directory a
phase, ``<RTC_PROFILE_DIR>/<phase with spaces as _>/``, each run adding
one ``<host>_<pid>.<ns>.pt.trace.json`` there.  The traced phases are
``dense_mst_device_compact`` (``ops/engine.py::compute_mst_device``),
``bitmap_filter_cluster`` (``ops/cluster_fast.py::threshold_clusters_device``,
the stream engine) and ``labelprop_cluster``
(``ops/labelprop.py::threshold_clusters_device_lp``).  Host activity is
always traced; CUDA activity (the ``csrc/`` kernels by name, copies,
memsets) when the phase runs on a CUDA device, and the spans opened in it
as ranges.  Unset or empty: nothing is made and no profiler starts.  A
profiler that cannot start costs one line on stderr and the phase runs
untraced.  An exception raised by the traced phase reaches the caller as
itself.

Where the card's clock drifts from the host's, Kineto drops the card's
records as out of its window in sessions that start long after the
process's first one (on an H100 host, from about 30 s on): a CLI run is
one process, so its traces hold its kernels, but a long-lived caller's
later traces may hold host activity only.
"""

from __future__ import annotations

import itertools
import os
import socket
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional

import torch

ENV_VAR = "RTC_PROFILE_DIR"

# traces written by this process and the host seconds their profilers took
# to start, stop and export: a timer around a traced phase subtracts the
# growth of trace_s
TRACE_STATS = {"traces": 0, "trace_s": 0.0}

_profiling = torch._C._autograd._profiler_enabled
_job_ids = itertools.count(1)
_span_ids = itertools.count(1)
_JOB: Optional["Job"] = None  # the open job scope


class Job:
    """One job scope: its id, its spans' records, its counters and the
    ids of its open spans, innermost last."""

    __slots__ = ("id", "spans", "counters", "open")

    def __init__(self):
        self.id = next(_job_ids)
        self.spans = []
        self.counters = {}
        self.open = [0]

    def summary(self) -> dict:
        """``{name: {"n", "total_s", "self_s"}}`` over the job's spans."""
        kids = defaultdict(list)
        for _, parent, _, _, t0, t1 in self.spans:
            kids[parent].append((t0, t1))
        out = {}
        for sid, _, _, name, t0, t1 in self.spans:
            covered, end = 0, t0
            for a, b in sorted(kids[sid]):
                a, b = max(a, end), min(b, t1)
                if b > a:
                    covered += b - a
                    end = b
            agg = out.setdefault(name, {"n": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            agg["n"] += 1
            agg["total_s"] += (t1 - t0) * 1e-9
            agg["self_s"] += (t1 - t0 - covered) * 1e-9
        return out


class span:
    """A named host range (see the module's docstring); ``seconds`` holds
    its duration after it closes."""

    __slots__ = ("name", "seconds", "_stats", "_key", "_job", "_id",
                 "_range", "_t0")

    def __init__(self, name: str, stats: Optional[dict] = None,
                 key: Optional[str] = None):
        self.name = name
        self.seconds = 0.0
        self._stats = stats
        self._key = key

    def __enter__(self) -> "span":
        self._job = job_ = _JOB
        if job_ is not None:
            self._id = next(_span_ids)
            job_.open.append(self._id)
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self.seconds = (t1 - self._t0) * 1e-9
        job_ = self._job
        if job_ is not None:
            job_.open.pop()
            job_.spans.append((self._id, job_.open[-1], job_.id, self.name,
                               self._t0, t1))
        if self._stats is not None:
            self._stats[self._key] = (self._stats.get(self._key, 0.0)
                                      + self.seconds)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open job's counter ``name``; nothing without a
    job scope."""
    if _JOB is not None:
        _JOB.counters[name] = _JOB.counters.get(name, 0) + n


@contextmanager
def job(stats: Optional[dict]):
    """The job scope around one job (the root span ``job``); yields the
    ``Job``, or None without ``stats``."""
    global _JOB
    if stats is None:
        with span("job"):
            yield None
        return
    this = Job()
    outer, _JOB = _JOB, this
    try:
        with span("job"):
            yield this
    finally:
        _JOB = outer
        stats["spans"] = this.summary()
        stats["counters"] = dict(this.counters)


class EventTimer:
    """Device milliseconds of the calls it wraps, from a pair of CUDA
    events around each; on another device the calls run untimed."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.events = []

    def __call__(self, fn, *args, **kw):
        if not self.cuda:
            return fn(*args, **kw)
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        out = fn(*args, **kw)
        ev1.record()
        self.events.append((ev0, ev1))
        return out

    def ms(self) -> float:
        """The wrapped calls' device milliseconds, waiting for the last."""
        if self.events:
            self.events[-1][1].synchronize()
        return sum(a.elapsed_time(z) for a, z in self.events)


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
