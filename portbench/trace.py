"""Reading of one ``torch.profiler`` trace (Chrome JSON) of one job: the
device's busy time, its kernels, its idle gaps and what the host did in
them."""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160


def short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def op_name(name: str) -> str:
    """A device operation's name without its return type, template
    arguments and parameters: ``void k<8>(int*)`` is ``k``."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    if "(" in name and not name.startswith("Mem"):
        name = name.split("(")[0]
    return name.split("<")[0].strip() or name


def merge(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, job_range: str) -> dict:
    """The job's window (the host range ``job_range``) and, inside it:
    ``busy_s`` (union of kernels, copies and memsets), ``kernels`` (name,
    seconds), ``device_ops`` (the TOP names by time) and ``idle_gaps``
    (the TOP longest gaps, named by the innermost host range over each
    gap's middle, else by the device operations on either side)."""
    job = [e for e in events if e.get("name") == job_range
           and e.get("cat") == "user_annotation"]
    if len(job) != 1:
        raise ValueError(f"{len(job)} host ranges named {job_range!r}")
    t0 = float(job[0]["ts"])
    t1 = t0 + float(job[0]["dur"])
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            a = max(float(e["ts"]), t0)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), t1)
            if b > a:
                dev.append((a, b, op_name(e.get("name", "?")), e["cat"]))
    busy = merge((a, b) for a, b, _, _ in dev)
    per_name = defaultdict(float)
    for a, b, name, _ in dev:
        per_name[name] += (b - a) * 1e-6
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", "?")) for e in events
            if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and e.get("name") != job_range]
    edges = [(t0, "job start")] + [(b, n) for a, b, n, _ in sorted(
        dev, key=lambda x: x[1])]
    gaps = []
    prev_end = t0
    for a, b in busy + [[t1, t1]]:
        if a > prev_end:
            gaps.append((prev_end, a))
        prev_end = max(prev_end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:TOP]:
        mid = (a + b) / 2
        over = [(he - hs, n) for hs, he, n in host if hs <= mid <= he]
        if over:
            label = "host " + min(over)[1]
        else:
            before = max((x for x in edges if x[0] <= a + 1e-3),
                         default=(t0, "job start"))[1]
            after = min(((d[0], d[2]) for d in dev if d[0] >= b - 1e-3),
                        default=(t1, "job end"))[1]
            label = f"host outside torch ops, after {short(before)}, " \
                    f"before {short(after)}"
        named.append([short(label), (b - a) * 1e-6])
    top = sorted(per_name.items(), key=lambda x: -x[1])[:TOP]
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": [(name, (b - a) * 1e-6) for a, b, name, cat in dev
                    if cat == "kernel"],
        "device_ops": [[short(n), s] for n, s in top],
        "idle_gaps": named,
        "device_events": len(dev),
        "first_device_s": (min(a for a, _, _, _ in dev) - t0) * 1e-6
        if dev else None,
        "last_device_s": (t1 - max(b for _, b, _, _ in dev)) * 1e-6
        if dev else None,
    }


def load(path: str):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Seconds of the kernels whose name holds ``fragment``."""
    return sum(s for name, s in summary["kernels"] if fragment in name)
