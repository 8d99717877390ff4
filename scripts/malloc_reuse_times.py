#!/usr/bin/env python3
"""Times the glibc malloc tuning that importing ``rabbittclust_tpu_torch``
applies (``_tune_malloc``: M_MMAP_THRESHOLD and M_TRIM_THRESHOLD at 1 GiB;
``RTC_MALLOC_REUSE=0`` keeps glibc's defaults) on the host of the card.

    python3 scripts/malloc_reuse_times.py [--n 131072] [--runs 3]
                                          [--device cuda]

Writes a ``--presketched`` folder of N genomes (``chip_smoke.py``'s
``make_corpus`` recipe: about 1,000 32-bit hashes a genome, 64 planted
clusters, seed 7), then runs fresh processes in turns (on, off, off, on,
...), ``--runs`` of each arm.  Each process imports the package under its
arm's ``RTC_MALLOC_REUSE`` and times

- ``state/sketch_io.py::load_kssd_sketches`` of the folder, twice (the
  second load allocates the sizes the first freed);
- the LP engine (``ops/labelprop.py::threshold_clusters_device_lp``) over
  the loaded sketches on ``--device``: its ``csr_s`` (the CSR flatten of
  every sketch) and ``total_s`` from ``LP_STATS``;
- its peak RSS (``resource.getrusage(RUSAGE_SELF).ru_maxrss``, KiB).

Prints one JSON line a process, then a summary line a metric (minimum,
median and maximum of each arm) and, last, the summary as one JSON object.
The folder lives in a temporary directory of the repository
(``chip_smoke_tmp_malloc*``) and is removed at the end.
"""

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("load_s", "reload_s", "csr_s", "lp_total_s", "maxrss_kib")


def make_corpus(n, s=1000, n_clusters=64, seed=7):
    """chip_smoke.py::make_corpus: genome i belongs to planted cluster
    i % n_clusters and keeps each of its base's hashes with probability
    0.8."""
    rng = np.random.default_rng(seed)
    bases = [np.unique(rng.integers(0, 2 ** 31, size=s).astype(np.uint32))
             for _ in range(n_clusters)]
    out = []
    for i in range(n):
        b = bases[i % n_clusters]
        keep = b[rng.random(len(b)) < 0.8]
        extra = np.unique(rng.integers(0, 2 ** 31, size=s - len(keep))
                          .astype(np.uint32))
        out.append(np.unique(np.concatenate([keep, extra])))
    return out


def save_presketched(hashes, folder, n_clusters=64):
    from rabbittclust_tpu_torch.sketch.base import SketchSet
    from rabbittclust_tpu_torch.sketch.kssd import KssdParams
    from rabbittclust_tpu_torch.state import sketch_io
    p = KssdParams.from_kmer_size(21, 3)
    ss = SketchSet("kssd", p, True, p.use64)
    for i, h in enumerate(hashes):
        ss.append_genome(file_name=f"genome_{i}.fna", name=f"genome_{i}",
                         comment=f"cluster{i % n_clusters}",
                         seq0_len=3_000_000, total_len=3_000_000,
                         num_seqs=1, hashes=h)
    sketch_io.save_kssd_sketches(ss, p, folder)


def child(folder, device):
    """One process's measures (the package is imported here, under the
    arm's RTC_MALLOC_REUSE)."""
    import torch  # noqa: F401  (before the clock: its import is no arm's)
    from rabbittclust_tpu_torch.ops import labelprop as lp
    from rabbittclust_tpu_torch.state import sketch_io
    clock = time.perf_counter
    t0 = clock()
    ss, p = sketch_io.load_kssd_sketches(folder)
    load_s = clock() - t0
    del ss
    t0 = clock()
    ss, p = sketch_io.load_kssd_sketches(folder)
    reload_s = clock() - t0
    clusters = lp.threshold_clusters_device_lp(ss.hashes, 0.05, p.kmer_size,
                                               device=device)
    return {"load_s": load_s, "reload_s": reload_s,
            "csr_s": lp.LP_STATS["csr_s"],
            "lp_total_s": lp.LP_STATS["total_s"],
            "clusters": len(clusters),
            "maxrss_kib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", metavar="FOLDER", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.device)))
        return 0
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("malloc_reuse_times: --device cuda needs a CUDA GPU",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, ROOT)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tmp_malloc",
                                     dir=ROOT) as tmp:
        folder = os.path.join(tmp, "sketches")
        t0 = time.perf_counter()
        save_presketched(make_corpus(args.n), folder)
        size = sum(os.path.getsize(os.path.join(folder, f))
                   for f in os.listdir(folder))
        print(f"corpus of {args.n} genomes saved in "
              f"{time.perf_counter() - t0:.3f} s ({size} B); host cores "
              f"{os.cpu_count()}", flush=True)
        runs = {"on": [], "off": []}
        order = []
        for r in range(args.runs):
            order += ["on", "off"] if r % 2 == 0 else ["off", "on"]
        for arm in order:
            env = dict(os.environ, RTC_MALLOC_REUSE="1" if arm == "on"
                       else "0", PYTHONPATH=ROOT)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 folder, "--device", args.device], env=env, cwd=ROOT,
                capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[arm].append(rec)
            print(json.dumps({"arm": arm, **rec}), flush=True)
    if len({r["clusters"] for arm in runs.values() for r in arm}) != 1:
        print("the arms' partitions differ in size", file=sys.stderr)
        return 1
    summary = {}
    for m in METRICS:
        summary[m] = {arm: [min(v), statistics.median(v), max(v)]
                      for arm in runs
                      for v in [[r[m] for r in runs[arm]]]}
        print(f"{m}: " + "; ".join(
            f"{arm} min {s[0]:.6g} median {s[1]:.6g} max {s[2]:.6g}"
            for arm, s in summary[m].items()))
    print(json.dumps({"n": args.n, "runs": args.runs,
                      "device": args.device, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
