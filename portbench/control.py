"""The control: the reference put in the program's place at a lower
precision, through the same run and the same judgement, which has to come
out not correct.

- ``float32``: every distance in float32, the step below the float64
  weights that ``kssd-mst`` states for ``edge.mst``.  A partition cannot
  fail by it: at these sizes no count lies nearer the threshold than
  float32 can tell apart (the configurations' ``guarantees``), so only
  the MST's weights show it.
- ``bits``: each pair's count taken from 8192-bit signatures (the buckets
  of ``hash & 8191`` that both genomes hold) in place of the exact count,
  as a program that skipped the exact verify would; it breaks the
  partition from exact counts that both configurations state.

On the card, at a cell's own size, one process over several seeds:

    python3 portbench/control.py --workload <cell> --precision <p> \
        --seeds <n> <n> <n> [--seconds 1]

prints one JSON line a seed with the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import sys
import tempfile
import time

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from portbench import harness, judge, reference  # noqa: E402


class ControlProgram:
    """The reference at ``precision`` as the system under test: it writes
    a ``.cluster`` file and, where the configuration saves it, an
    ``edge.mst``, as the program does."""

    def __init__(self, config, corpus, device, workdir, precision):
        self.corpus, self.device = corpus, device
        self.precision = precision
        self.kmer = reference.kssd_kmer(config["kmer_size"])
        self.out = os.path.join(workdir, "job.cluster")
        self.folder = os.path.join(workdir, "run")
        _, self.args = harness.parse_command(config, self.out, self.folder)
        self.files = {"cluster": self.out}
        if not self.args.no_save:
            self.files["mst"] = os.path.join(self.folder, "edge.mst")

    def job(self) -> dict:
        t0 = time.perf_counter()
        c = self.corpus
        plan = reference.make_plan(c.flat, c.offsets, c.group, self.device)
        thr = self.args.threshold
        labels = reference.partition(plan, thr, self.kmer, self.precision)
        write_clusters(self.out, labels)
        if "mst" in self.files:
            f = reference.forest(plan, thr, self.kmer, self.precision)
            w = f.weights[np.searchsorted(f.keys, f.mst_keys)]
            write_mst(self.files["mst"], f.mst_keys // c.n,
                      f.mst_keys % c.n, w)
        return {"wall_s": time.perf_counter() - t0, "stats": {},
                "lp_stats": {"panels": 0}}

    keep = harness.Program.keep


def write_clusters(path: str, labels: np.ndarray) -> None:
    """The partition as ``.cluster`` rows: cluster headers, then a row of
    (index in the cluster, genome id) a member."""
    order = np.argsort(labels, kind="stable")
    cuts = np.flatnonzero(np.diff(labels[order])) + 1
    with open(path, "w") as f:
        for ci, members in enumerate(np.split(order, cuts)):
            f.write(f"the cluster {ci} is: \n")
            f.writelines(f"\t{li}\t{g}\n" for li, g in enumerate(members))
            f.write("\n")


def write_mst(path: str, i, j, w) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec = np.zeros(len(i), dtype=judge.EDGE)
    rec["i"], rec["j"], rec["d"] = i, j, w
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(i)))
        f.write(rec.tobytes())


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--precision", required=True,
                    choices=reference.PRECISIONS[1:])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell.load(json.load(f), args.workload)
    if not torch.cuda.is_available():
        harness.say("control: needs a CUDA device")
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            result, checks = harness.execute(
                cell, seed, args.seconds, False, device,
                time.perf_counter(), workdir,
                make_program=lambda *a: ControlProgram(*a, args.precision))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision,
                          "correct": result["correct"], "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
