"""One run of one cell of ``BENCHMARK.json``.

In order: the cell's corpus from ``--seed`` (on the card), the SketchSet as
a ``--presketched`` load gives it, one warm-up job (set-up ends there),
with ``--trace 1`` one job under ``torch.profiler``, then jobs back to back
until one ends ``--seconds`` or more after the first began (the window).
A job is what the configuration's command runs after its
``--presketched`` load, one call of ``workflows.compute_kssd_clusters``;
its files are moved aside after it, so the next job writes anew and every
job's files are judged.  After the window: the device's peak, a look for
JAX in ``sys.modules``, the reference, the judgement, and the result as
the last line of standard output.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import corpus as corpus_mod
from . import judge, reference, roofline, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "rabbittclust_tpu")
JOB_RANGE = "portbench.job"
# the port's commands that the reference can judge, and their parser's
# module
COMMANDS = {"clust-mst": "mst"}
CONFIG_KEYS = {"name", "command", "kmer_size", "drlevel", "genomes",
               "source", "guarantees", "reduced", "reduced_why", "assumed",
               "limits"}
TRAFFIC_KEYS = {"genomes_per_species", "zipf_exponent", "base_hashes",
                "keep", "sketch_size", "planted_pairs", "bases_per_hash",
                "sources", "assumed"}


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Cell:
    """A workload of the spec with its configuration, traffic and the
    metrics it reports."""
    name: str
    cell: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def load(cls, spec: dict, name: str, root: str = ROOT) -> "Cell":
        """The workload ``name``: its configuration from the file its
        entry names, its traffic from ``traffic/<traffic>.json``, each
        checked for keys the harness does not read."""
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = cells[name]
        entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
        with open(os.path.join(root, entry["file"])) as f:
            config = json.load(f)
        with open(os.path.join(HERE, "traffic",
                               cell["traffic"] + ".json")) as f:
            traffic = json.load(f)
        for what, keys, known in (
                (entry["file"], config, CONFIG_KEYS),
                (f"traffic/{cell['traffic']}.json", traffic, TRAFFIC_KEYS)):
            unknown = sorted(set(keys) - known)
            if unknown:
                raise ValueError(f"{what}: keys the harness does not read: "
                                 f"{', '.join(unknown)}")
        parse_command(config)
        untied = [m["name"] for m in spec["per_layer"]
                  if "workloads" not in m]
        if untied:
            raise ValueError("per-layer metrics without workloads: "
                             + ", ".join(untied))
        e2e = [m for m in spec["end_to_end"]
               if name in m.get("workloads", [name])]
        per_layer = [m for m in spec["per_layer"] if name in m["workloads"]]
        return cls(name, cell, config, traffic, e2e, per_layer)


def parse_command(config: dict, out: str = "<out>",
                  sketches: str = "<sketches>"):
    """The configuration's ``command``, parsed by the port's own CLI
    parser with ``<out>`` and ``<sketches>`` put in; (module, args).  Only
    the arm the harness drives and the reference judges passes:
    ``clust-mst --fast --device --presketched <sketches> -o <out> -d ...``
    over the configuration's k and drlevel, with no flag that changes
    what the ``.cluster`` file means or reads other input."""
    from rabbittclust_tpu_torch.cli.common import base_parser
    cmd = config["command"]
    name = config.get("name", "?")
    if cmd[0] not in COMMANDS:
        raise ValueError(f"{name}: {cmd[0]!r} has no plain reference here "
                         f"(known: {', '.join(COMMANDS)})")
    module = COMMANDS[cmd[0]]
    argv = [{"<out>": out, "<sketches>": sketches}.get(a, a)
            for a in cmd[1:]]
    try:
        args = base_parser(module).parse_args(argv)
    except SystemExit as e:
        raise ValueError(f"{name}: the command does not parse: "
                         f"{' '.join(cmd)}") from e
    problems = [what for what, bad in (
        ("--fast missing", not args.is_fast),
        ("--device missing", not args.use_device),
        ("--presketched <sketches> missing", args.presketched != sketches),
        ("-o <out> missing", args.output != out),
        ("-d missing", args.threshold is None),
        ("--sketch-func", args.sketch_func != "MinHash"),
        ("-c", args.contain_compress is not None),
        ("--append", args.append), ("--premsted", args.premsted),
        ("--db", args.repdb_path), ("--multihost", args.multihost),
        ("--buildDB", args.build_db),
        ("--auto-threshold", args.auto_threshold),
        ("-k other than kmer_size",
         args.kmer_size not in (None, config["kmer_size"])),
        ("--drlevel other than drlevel", args.drlevel != config["drlevel"]),
        ("limits name mst_gap exactly where edge.mst is saved",
         ("mst_gap" in config["limits"]) == args.no_save),
    ) if bad]
    if problems:
        raise ValueError(f"{name}: the harness cannot drive or judge this "
                         f"command: {'; '.join(problems)}")
    return module, args


class Program:
    """The system under test: what the configuration's command runs after
    its ``--presketched`` load, ``compute_kssd_clusters`` over the corpus
    as a SketchSet."""

    def __init__(self, config: dict, corpus, device: torch.device,
                 workdir: str):
        from rabbittclust_tpu_torch import workflows
        from rabbittclust_tpu_torch.cli.common import make_output_options
        from rabbittclust_tpu_torch.ops import labelprop
        from rabbittclust_tpu_torch.sketch.base import SketchSet
        from rabbittclust_tpu_torch.sketch.kssd import KssdParams
        self.workflows, self.labelprop = workflows, labelprop
        self.out = os.path.join(workdir, "job.cluster")
        self.folder = os.path.join(workdir, "run")
        self.module, self.args = parse_command(config, self.out,
                                               self.folder)
        self.params = KssdParams.from_kmer_size(config["kmer_size"],
                                                config["drlevel"])
        ss = SketchSet("kssd", self.params, True, self.params.use64)
        for i, (h, length) in enumerate(zip(corpus.hashes(),
                                            corpus.lengths.tolist())):
            ss.append_genome(file_name=f"genome_{i}.fna",
                             name=f"genome_{i}", comment="",
                             seq0_len=length, total_len=length, num_seqs=1,
                             hashes=h)
        self.ss = ss
        self.opts = make_output_options(self.args)
        self.device = device
        self.files = {"cluster": self.out}
        if not self.args.no_save:
            self.files["mst"] = os.path.join(self.folder, "edge.mst")

    def job(self) -> dict:
        stats: dict = {}
        a = self.args
        t0 = time.perf_counter()
        self.workflows.compute_kssd_clusters(
            self.ss, self.params, a.threshold, self.out,
            a.contain_compress is not None, self.opts, self.folder,
            self.device, stats=stats, threads=a.threads, module=self.module)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"wall_s": time.perf_counter() - t0, "stats": stats,
                "lp_stats": dict(self.labelprop.LP_STATS)}

    def keep(self, tag) -> Optional[dict]:
        """Move the last job's files aside under ``tag``; their paths, or
        None where the job left one out."""
        kept = {}
        for name, path in self.files.items():
            try:
                os.replace(path, f"{path}.{tag}")
            except FileNotFoundError:
                return None
            kept[name] = f"{path}.{tag}"
        return kept


@dataclass
class Run:
    """What a per-layer metric's reader reads."""
    config: dict
    traffic: dict
    corpus: object
    jobs: List[dict] = field(default_factory=list)  # the window's jobs
    trace: Optional[dict] = None    # trace.summarize of the profiled job


def profiled_job(program: Program, workdir: str):
    """One job under a torch.profiler session (the process's first), in
    the host range JOB_RANGE; (its record, the trace's summary)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if program.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        started = time.perf_counter() - t0
        with record_function(JOB_RANGE):
            rec = program.job()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    summary = trace.summarize(trace.load(path), JOB_RANGE)
    os.remove(path)
    say(f"profiler: start {started:.3f} s, start to export "
        f"{time.perf_counter() - t0:.3f} s; job {rec['wall_s']:.3f} s; "
        f"{summary['device_events']} device events, the first "
        f"{summary['first_device_s']} s after the job's start, the last "
        f"{summary['last_device_s']} s before its end")
    return rec, summary


def read_metric(name: str, run: Run):
    """The value of per-layer metric ``name`` from its reader,
    ``metrics/<name>.py``'s ``read(run)``; None where it finds nothing."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def card_limits() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def job_line(k, rec: dict) -> str:
    st = {key: v for key, v in rec["stats"].items()
          if key.endswith(("_s", "_ms"))}
    if rec["lp_stats"].get("panels"):
        st.update({f"lp.{key}": v for key, v in rec["lp_stats"].items()
                   if key.endswith(("_s", "_ms")) or key == "rounds"})
    return f"job {k}: {rec['wall_s']:.3f} s; " + ", ".join(
        f"{key} {v:.4g}" for key, v in st.items())


def run_window(program, seconds: float, clock=time.perf_counter):
    """Jobs back to back until one ends ``seconds`` or more after the
    first began: (their records, their kept files, the window's length
    from the first job's start to the last one's end)."""
    jobs, kept = [], []
    start = clock()
    while True:
        jobs.append(program.job())
        kept.append(program.keep(len(jobs)))
        if clock() - start >= seconds:
            return jobs, kept, clock() - start


def execute(cell: Cell, seed: int, seconds: float, traced: bool,
            device: torch.device, t0: float, workdir: str,
            make_program=Program):
    """The run; (the result's fields, the numbers compared).
    ``make_program(config, corpus, device, workdir)`` builds the system
    under test (the control puts the reference there)."""
    cfg = cell.config
    _, args = parse_command(cfg)
    cuda = device.type == "cuda"
    kmer = reference.kssd_kmer(cfg["kmer_size"])
    t_gen = time.perf_counter()
    corpus = corpus_mod.generate(cell.traffic, cfg["genomes"],
                                 args.threshold, kmer, seed, device)
    say(f"corpus: {corpus.n} genomes, {len(corpus.flat)} hashes, sizes "
        f"{corpus.sizes.min()}-{corpus.sizes.max()}, planted pairs at "
        f"D = {', '.join(f'{d:.9f}' for d in corpus.planted_d)} "
        f"in {time.perf_counter() - t_gen:.3f} s, "
        f"{time.perf_counter() - t0:.3f} s from the start")
    t_build = time.perf_counter()
    program = make_program(cfg, corpus, device, workdir)
    say(f"system under test built in {time.perf_counter() - t_build:.3f} s")
    warm = program.job()
    program.keep("warm")
    say(f"warm-up job {warm['wall_s']:.3f} s")
    run = Run(config=cfg, traffic=cell.traffic, corpus=corpus)
    files = []
    setup_s = time.perf_counter() - t0
    if traced:
        _, run.trace = profiled_job(program, workdir)
        files.append(program.keep("traced"))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    jobs, kept, window_s = run_window(program, seconds)
    run.jobs += jobs
    files += kept
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    for k, rec in enumerate(run.jobs):
        say(job_line(k, rec))
    say(f"window: {len(run.jobs)} jobs in {window_s:.3f} s")
    found = banned_modules()
    if found:
        return None, found

    del program
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    plan = reference.make_plan(corpus.flat, corpus.offsets, corpus.group,
                               device)
    labels = reference.partition(plan, args.threshold, kmer)
    forest = None if args.no_save else reference.forest(
        plan, args.threshold, kmer)
    del plan
    worst, failed = judge.judge_jobs(files, cfg["limits"], labels, forest,
                                     say)
    say(f"reference and judgement {time.perf_counter() - t_ref:.3f} s: "
        f"{len(np.unique(labels))} clusters")
    for f in files:
        for p in (f or {}).values():
            os.remove(p)

    checks = {k: {"value": worst[k], "limit": lim}
              for k, lim in cfg["limits"].items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.cell["chips"], "memory_peak_bytes": int(peak)}
    metrics = {}
    result = {"correct": correct, "attempted": len(files), "failed": failed}
    if traced:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        for m in cell.per_layer:
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        have = {"job_s": window_s / len(run.jobs),
                "peak_dev_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": have[m["name"]],
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    if traced:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    return result, checks


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = Cell.load(json.load(f), args.workload)
    want = cell.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        say(f"portbench: {args.workload} needs {want} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    say(f"card: {card_limits()}; peaks: HBM {roofline.HBM_BPS:.4g} B/s, "
        f".b1 {roofline.B1_OPS:.5g} op/s, INT32 {roofline.INT32_OPS:.5g} "
        f"op/s")
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        result, checks = execute(cell, args.seed, args.seconds,
                                 bool(args.trace), device, t0, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if result is None:
        say("portbench: modules of JAX or the JAX package are loaded: "
            + ", ".join(checks))
        return 3
    for name, c in checks.items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result))
    return 0
