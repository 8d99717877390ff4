"""The comparison that decides ``correct``: what each timed job wrote (its
``.cluster`` file and, where the configuration saves it, its run folder's
``edge.mst``) against the reference.

Two numbers, each held to the limit its configuration's ``limits`` gives
(a number passes at or below its limit), the largest over the jobs:

- ``partition_gap``: 2 |{(cluster, reference cluster) of a genome}| -
  clusters - reference clusters over the genomes listed (0 exactly when
  the partitions are equal), plus the genomes unlisted and the rows that
  repeat a genome or name none; a job that left a file out reads n.
- ``mst_gap``: the largest of |weight - the reference's distance of that
  pair| over ``edge.mst``'s rows and of the gap between its weights and
  the reference forest's, both ascending (every minimum spanning forest
  of a graph has the same sorted weights); 1.0, the widest a distance
  gap can be, where a row is no edge of the MST graph, rows close a
  cycle, the row count is not the forest's, or a file is left out.

The parts of each (``genomes_gap``, ``forest_gap``, ``edge_weight_gap``,
``mst_weight_gap``) go to standard error.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np

from .reference import Forest

EDGE = np.dtype([("i", "<i4"), ("j", "<i4"), ("d", "<f8")])


def digest(paths) -> str:
    h = hashlib.sha1()
    for p in paths:
        with open(p, "rb") as f:
            for block in iter(lambda: f.read(1 << 22), b""):
                h.update(block)
    return h.hexdigest()


def read_clusters(path: str, n: int):
    """(cluster of each genome, -1 where unlisted; rows that repeat a
    genome or name none of the corpus)."""
    labels = np.full(n, -1, dtype=np.int64)
    bad = 0
    ci = -1
    with open(path) as f:
        for line in f:
            if line.startswith("the cluster"):
                ci += 1
            elif line.startswith("\t"):
                try:
                    g = int(line.split("\t", 3)[2])
                except (IndexError, ValueError):
                    bad += 1
                    continue
                if not 0 <= g < n or labels[g] >= 0 or ci < 0:
                    bad += 1
                else:
                    labels[g] = ci
    return labels, bad


def partition_numbers(labels: np.ndarray, bad: int,
                      ref: np.ndarray) -> dict:
    listed = labels >= 0
    p, r = labels[listed], ref[listed]
    pairs = len(np.unique(p * (int(r.max(initial=0)) + 1) + r))
    return {"genomes_gap": int((~listed).sum()) + bad,
            "partition_gap": 2 * pairs - len(np.unique(p)) -
            len(np.unique(r))}


def read_mst(path: str):
    with open(path, "rb") as f:
        (m,) = struct.unpack("<Q", f.read(8))
        rec = np.frombuffer(f.read(m * EDGE.itemsize), dtype=EDGE)
    if len(rec) != m:
        raise ValueError(f"{path}: {len(rec)} of {m} rows")
    return (rec["i"].astype(np.int64), rec["j"].astype(np.int64),
            rec["d"].astype(np.float64))


def mst_numbers(edges, ref: Forest) -> dict:
    i, j, w = edges
    n = ref.n
    a, b = np.minimum(i, j), np.maximum(i, j)
    inside = (a >= 0) & (b < n) & (a != b)
    key = np.where(inside, a * n + b, -1)
    if len(ref.keys):
        at = np.minimum(np.searchsorted(ref.keys, key), len(ref.keys) - 1)
        found = inside & (ref.keys[at] == key)
    else:
        at = np.zeros(len(key), dtype=np.int64)
        found = np.zeros(len(key), dtype=bool)
    gap = float(np.abs(w[found] - ref.weights[at[found]]).max(initial=0.0))
    parent = np.arange(n)

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    cycles = 0
    for u, v in zip(a[found].tolist(), b[found].tolist()):
        ru, rv = find(u), find(v)
        if ru == rv:
            cycles += 1
        else:
            parent[max(ru, rv)] = min(ru, rv)
    want = n - ref.components
    sw = np.sort(w)
    return {"forest_gap": int((~found).sum()) + cycles + abs(len(w) - want),
            "edge_weight_gap": gap,
            "mst_weight_gap": float(np.abs(sw - ref.mst_weights).max(
                initial=0.0)) if len(sw) == len(ref.mst_weights) else 1.0}


def judge_outputs(files: dict, ref_labels: np.ndarray,
                  ref_forest=None) -> dict:
    """The numbers of one job's files (``cluster``, and ``mst`` where the
    configuration saves it)."""
    labels, bad = read_clusters(files["cluster"], len(ref_labels))
    out = partition_numbers(labels, bad, ref_labels)
    if "mst" in files:
        try:
            out.update(mst_numbers(read_mst(files["mst"]), ref_forest))
        except (ValueError, struct.error):  # a torn or short file
            out.update(forest_gap=ref_forest.n, edge_weight_gap=1.0,
                       mst_weight_gap=1.0)
    return out


def numbers(parts: dict) -> dict:
    """The two numbers compared, from a job's parts."""
    out = {"partition_gap": parts["partition_gap"] + parts["genomes_gap"]}
    if "forest_gap" in parts:
        out["mst_gap"] = 1.0 if parts["forest_gap"] else max(
            parts["edge_weight_gap"], parts["mst_weight_gap"])
    return out


def judge_jobs(jobs_files, limits: dict, ref_labels, ref_forest=None,
               say=None):
    """(the largest reading of each number over the jobs, jobs that failed
    a limit or left a file out).  ``jobs_files`` holds one dict of output
    paths a job, or None for a job whose files are missing; equal files
    are read once, and their parts are passed to ``say``."""
    worst = {k: 0 for k in limits}
    failed = 0
    seen = {}
    for files in jobs_files:
        if files is None or not all(os.path.exists(p)
                                    for p in files.values()):
            nums = {"partition_gap": len(ref_labels), "mst_gap": 1.0}
        else:
            key = digest(files[k] for k in sorted(files))
            if key not in seen:
                parts = judge_outputs(files, ref_labels, ref_forest)
                if say is not None:
                    say(f"judged {key[:12]}: {parts}")
                seen[key] = numbers(parts)
            nums = seen[key]
        nums = {k: v for k, v in nums.items() if k in limits}
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
        if any(v > limits[k] for k, v in nums.items()):
            failed += 1
    return worst, failed
