"""Whole runs on the CPU at a tiny size, with the port's plain versions:
the result line's shape, the controls and the faults that have to come
out not correct, the window's arithmetic, the trace's reading, and the
look for JAX."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import control, harness, trace
from portbench.tests.helpers import CPU, SEED, small_cell, spec

CELLS = ("mst-e.refseq-290k", "mst.refseq-16k")


def run_cell(workload, tmp_path, traced=False, make_program=harness.Program,
             seed=SEED):
    cell = small_cell(workload)
    result, checks = harness.execute(cell, seed, 0.01, traced, CPU,
                                     time.perf_counter(), str(tmp_path),
                                     make_program=make_program)
    return cell, result, checks


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line_shape(workload, traced, tmp_path):
    cell, result, checks = run_cell(workload, tmp_path, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if traced else ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1 + traced
    json.dumps(result, allow_nan=False)
    wanted = cell.per_layer if traced else cell.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(result["metrics"]) <= set(units)
    if not traced:
        assert set(result["metrics"]) == {"job_s", "peak_dev_gib",
                                          "setup_s"}
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and np.isfinite(m["value"])
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert dev["window_s"] > 0
        for k in ("device_ops", "idle_gaps"):
            rows = result["breakdown"][k]
            assert len(rows) <= 10
            assert all(isinstance(n, str) and s >= 0 for n, s in rows)
    assert set(result["checks"]) == set(cell.config["limits"])
    assert all(set(c) == {"value", "limit"} for c in checks.values())


@pytest.mark.parametrize("workload,precision,correct", [
    ("mst-e.refseq-290k", "bits", False),
    ("mst-e.refseq-290k", "float32", True),   # no count near enough
    ("mst.refseq-16k", "float32", False),
    ("mst.refseq-16k", "bits", False),
])
def test_controls(workload, precision, correct, tmp_path):
    _, result, checks = run_cell(
        workload, tmp_path,
        make_program=lambda *a: control.ControlProgram(*a, precision))
    assert result["correct"] is correct, checks


class Unchanged(harness.Program):
    """A job that returns and leaves its state as it was: no file."""

    def job(self):
        return {"wall_s": 0.0, "stats": {}, "lp_stats": {"panels": 0}}


class HalfLeftOut(harness.Program):
    """A job over the first half of the genomes only."""

    def job(self):
        full, h = self.ss, len(self.ss) // 2
        self.ss = dataclasses.replace(full, **{
            f.name: getattr(full, f.name)[:h]
            for f in dataclasses.fields(full)
            if isinstance(getattr(full, f.name), list)})
        try:
            return super().job()
        finally:
            self.ss = full


class AnswerAltered(harness.Program):
    """A job whose answer is altered where it is made: two genomes of
    different clusters swap places, and one MST weight moves by 1e-9."""

    def job(self):
        rec = super().job()
        lines = open(self.out).read().splitlines(keepends=True)
        rows = [k for k, s in enumerate(lines) if s.startswith("\t")]
        first = lines[rows[0]].split("\t")
        last = lines[rows[-1]].split("\t")
        first[2], last[2] = last[2], first[2]
        lines[rows[0]], lines[rows[-1]] = "\t".join(first), "\t".join(last)
        open(self.out, "w").writelines(lines)
        if "mst" in self.files:
            path = self.files["mst"]
            data = bytearray(open(path, "rb").read())
            w = np.frombuffer(data, dtype="<f8", count=1, offset=8 + 8)
            data[16:24] = (w + 1e-9).tobytes()
            open(path, "wb").write(bytes(data))
        return rec


@pytest.mark.parametrize("fault", [Unchanged, HalfLeftOut, AnswerAltered])
@pytest.mark.parametrize("workload", CELLS)
def test_faults_come_out_not_correct(workload, fault, tmp_path):
    _, result, checks = run_cell(workload, tmp_path, make_program=fault)
    assert result["correct"] is False
    assert result["failed"] >= 1, checks


class FakeProgram:
    """Jobs of 0.1 s on a fake clock, one of them stalled."""

    def __init__(self, stall_at=None, stall=0.5):
        self.now, self.k, self.stall_at, self.stall = 0.0, 0, stall_at, stall

    def job(self):
        self.k += 1
        self.now += 0.1 + (self.stall if self.k == self.stall_at else 0.0)
        return {"wall_s": 0.1}

    def keep(self, tag):
        return {}

    def clock(self):
        return self.now


def test_job_s_counts_a_stall():
    steady, stalled = FakeProgram(), FakeProgram(stall_at=3)
    out = []
    for p in (steady, stalled):
        jobs, _, window = harness.run_window(p, 1.0, clock=p.clock)
        out.append(window / len(jobs))
    assert out[0] == pytest.approx(0.1)
    assert out[1] > out[0] * 1.4  # 1.5 s over 10 jobs against 1.0 s


def test_trace_summary_of_a_synthetic_job():
    x = "X"
    events = [
        {"ph": x, "cat": "user_annotation", "name": "job", "ts": 0,
         "dur": 1000},
        {"ph": x, "cat": "kernel", "ts": 100, "dur": 200,
         "name": "void (anonymous namespace)::filter_mask_kernel<8>(int*)"},
        {"ph": x, "cat": "gpu_memcpy", "ts": 250, "dur": 150,
         "name": "Memcpy DtoH (Device -> Pinned)"},
        {"ph": x, "cat": "kernel", "ts": 600, "dur": 100,
         "name": "void lp_round_kernel<4>(int const*)"},
        {"ph": x, "cat": "cpu_op", "ts": 420, "dur": 170,
         "name": "aten::copy_"},
    ]
    s = trace.summarize(events, "job")
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(400e-6)
    assert trace.kernel_seconds(s, "filter_mask_kernel") == \
        pytest.approx(200e-6)
    assert s["device_ops"][0] == ["filter_mask_kernel", pytest.approx(2e-4)]
    gaps = s["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([300e-6, 200e-6, 100e-6])
    assert gaps[1][0] == "host aten::copy_"
    assert "after lp_round_kernel" in gaps[0][0]


def test_every_layer_metric_has_a_reader_that_may_find_nothing():
    empty = harness.Run(config={}, traffic={}, corpus=None)
    for m in spec()["per_layer"]:
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
        assert harness.read_metric(m["name"], empty) is None


def test_banned_names_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxlib.xla_client", "rabbittclust_tpu.ops",
                 "rabbittclust_tpu_torch.ops", "jaxtyping", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = harness.banned_modules()
    assert "jaxlib.xla_client" in found and "rabbittclust_tpu.ops" in found
    assert "flax" in found
    assert "rabbittclust_tpu_torch.ops" not in found
    assert "jaxtyping" not in found


def test_no_jax_after_a_job():
    code = (
        "import sys, tempfile, json, torch\n"
        "from portbench import harness, corpus\n"
        "from portbench.tests.helpers import small_traffic, spec\n"
        "cell = harness.Cell.load(spec(), 'mst.refseq-16k')\n"
        "c = corpus.generate(small_traffic(genomes=64, species=4), 64, "
        "0.05, 22, 7, torch.device('cpu'))\n"
        "p = harness.Program(cell.config, c, torch.device('cpu'), "
        "tempfile.mkdtemp())\n"
        "p.job()\n"
        "print(json.dumps(harness.banned_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[1],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[1],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True


def _edited(cmd=None, **keys):
    cfg = dict(harness.Cell.load(spec(), CELLS[0]).config, **keys)
    if cmd is not None:
        cfg["command"] = cmd(cfg["command"])
    return cfg


@pytest.mark.parametrize("case", [
    "greedy", "unknown flag", "append", "containment", "no presketched",
    "other k", "mst saved but not judged", "unknown key"])
def test_a_config_the_harness_cannot_drive_fails_loudly(case, tmp_path):
    cfg = {
        "greedy": lambda: _edited(lambda c: ["clust-greedy"] + c[1:]),
        "unknown flag": lambda: _edited(lambda c: c + ["--no-such-flag"]),
        "append": lambda: _edited(lambda c: c + ["--append", "x.list"]),
        "containment": lambda: _edited(lambda c: c + ["-c", "1000"]),
        "no presketched": lambda: _edited(lambda c: c[:-4] + c[-2:]),
        "other k": lambda: _edited(lambda c: c + ["-k", "19"]),
        "mst saved but not judged": lambda: _edited(
            lambda c: [a for a in c if a != "-e"]),
        "unknown key": lambda: _edited(sketch_func="WMH"),
    }[case]()
    s = spec()
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    s["configs"][0]["file"] = "cfg.json"
    with pytest.raises(ValueError):
        harness.Cell.load(s, CELLS[0], root=str(tmp_path))


def test_the_command_decides_what_runs():
    module, args = harness.parse_command(
        harness.Cell.load(spec(), CELLS[0]).config, "o.cluster", "run")
    assert module == "mst" and args.no_save and args.threads == 8
    assert args.threshold == 0.05 and args.output == "o.cluster"
    _, args = harness.parse_command(
        harness.Cell.load(spec(), CELLS[1]).config, "o.cluster", "run")
    assert not args.no_save and args.presketched == "run"


def test_a_layer_metric_without_workloads_fails_loudly():
    s = spec()
    del s["per_layer"][0]["workloads"]
    with pytest.raises(ValueError):
        harness.Cell.load(s, CELLS[0])
