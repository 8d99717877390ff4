"""The profiler hook ``RTC_PROFILE_DIR`` (``utils/profiling.py::
maybe_trace``) of the port against the JAX package's, on the CPU.

With the variable set, the port's CLI makes the same phase directories as
the JAX CLI for the same argv (the MST-free ``-e`` stream and forced LP
engines, the full MST through the dense engine), each holding one
Chrome/Perfetto JSON trace of the port's; empty or unset, neither package
makes anything.  An exception in a traced body reaches the caller as
itself, and a profiler that cannot start leaves the body untraced."""

import json
import os

import pytest
import torch

from rabbittclust_tpu.cli.clust_mst import main as jax_main
from rabbittclust_tpu_torch.cli.clust_mst import main as port_main
from rabbittclust_tpu_torch.ops import engine as port_engine
from rabbittclust_tpu_torch.ops import labelprop as port_lp
from rabbittclust_tpu_torch.utils import profiling

CPU = torch.device("cpu")

# argv, environment, the phase directories the run makes
RUNS = {
    "stream": (["-e"], {"RTC_PULL_MODE": "mask"},
               ["bitmap_filter_cluster"]),
    "lp": (["-e"], {"RTC_CLUSTER_ENGINE": "lp"}, ["labelprop_cluster"]),
    "dense": ([], {"RTC_MST_CLUSTERS_FAST": "0"},
              ["dense_mst_device_compact"]),
}


def _argv(genomes):
    return ["--fast", "--device", "-l", "-i", genomes.list_file, "-d",
            "0.05", "--drlevel", "2", "-m", "1000"]


def _run(side, argv, wd, monkeypatch):
    wd.mkdir(parents=True)
    monkeypatch.chdir(wd)
    out = str(wd / "out.cluster")
    if side == "port":
        stats = {}
        assert port_main(argv + ["-o", out], device=CPU, stats=stats) == 0
        return out, stats
    assert jax_main(argv + ["-o", out]) == 0
    return out, None


def _dirs(root):
    return sorted(os.listdir(root)) if os.path.isdir(root) else []


@pytest.mark.parametrize("run", list(RUNS))
def test_phase_directories_match_jax(run, synthetic_genomes, tmp_path,
                                     monkeypatch):
    extra, env, phases = RUNS[run]
    monkeypatch.setenv("RTC_MESH", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = _argv(synthetic_genomes) + extra
    outs, stats = {}, None
    for side in ("jax", "port"):
        prof = tmp_path / f"{side}_prof"
        monkeypatch.setenv("RTC_PROFILE_DIR", str(prof))
        outs[side], st = _run(side, argv, tmp_path / side, monkeypatch)
        stats = st or stats
        assert _dirs(prof) == phases, side
    with open(outs["jax"], "rb") as a, open(outs["port"], "rb") as b:
        assert a.read() == b.read()  # traced runs still agree
    # one parseable trace a phase, with the engine's host work in it
    for phase in phases:
        d = tmp_path / "port_prof" / phase
        files = os.listdir(d)
        assert len(files) == 1 and files[0].endswith(".pt.trace.json")
        with open(d / files[0]) as f:
            trace = json.load(f)
        assert trace["traceEvents"]
    trace_s = (stats["trace_s"] if run == "dense"
               else port_lp.LP_STATS["trace_s"] if run == "lp" else None)
    assert trace_s is None or trace_s > 0.0


@pytest.mark.parametrize("value", [None, ""])
def test_unset_or_empty_makes_nothing(value, synthetic_genomes, tmp_path,
                                      monkeypatch):
    monkeypatch.setenv("RTC_MESH", "0")
    monkeypatch.setenv("RTC_PULL_MODE", "mask")
    if value is None:
        monkeypatch.delenv("RTC_PROFILE_DIR", raising=False)
    else:
        monkeypatch.setenv("RTC_PROFILE_DIR", value)
    for side in ("jax", "port"):
        wd = tmp_path / side
        before = profiling.TRACE_STATS["traces"]
        _run(side, _argv(synthetic_genomes) + ["-e"], wd, monkeypatch)
        # the working directory holds the cluster file and nothing else
        assert sorted(os.listdir(wd)) == ["out.cluster"], side
        assert profiling.TRACE_STATS["traces"] == before


def test_untraced_engine_reports_no_trace_time(synthetic_genomes,
                                               monkeypatch):
    from rabbittclust_tpu_torch.sketch.kssd import sketch_files_kssd
    monkeypatch.delenv("RTC_PROFILE_DIR", raising=False)
    ss, p = sketch_files_kssd(synthetic_genomes.files, 1000, 21, 2, 1)
    stats = {}
    port_engine.compute_mst_device(ss.hashes, 0.05, p.kmer_size,
                                   device=CPU, stats=stats)
    assert stats["trace_s"] == 0.0


class _Mine(Exception):
    pass


@pytest.mark.parametrize("value", ["set", ""])
def test_body_exception_propagates(value, tmp_path, monkeypatch):
    """The JAX hook yields a second time when its body raises, so its
    caller gets ``RuntimeError: generator didn't stop after throw()``; the
    port's lets the body's exception through as itself."""
    monkeypatch.setenv("RTC_PROFILE_DIR",
                       str(tmp_path / "prof") if value else "")
    err = _Mine("from the body")
    with pytest.raises(_Mine) as info:
        with profiling.maybe_trace("failing phase", CPU) as trace:
            raise err
    assert info.value is err
    assert trace.path is None
    # the profiler was stopped: the next phase traces normally
    with profiling.maybe_trace("next phase", CPU) as trace:
        torch.ones(8).sum()
    assert (trace.path is not None) == bool(value)


def test_profiler_that_cannot_start_is_tolerated(tmp_path, monkeypatch,
                                                 capsys):
    import torch.profiler

    class Broken:
        def __init__(self, *a, **kw):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    monkeypatch.setenv("RTC_PROFILE_DIR", str(tmp_path / "prof"))
    ran = []
    with profiling.maybe_trace("phase", CPU) as trace:
        ran.append(1)
    assert ran == [1] and trace.path is None and trace.seconds == 0.0
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "runs untraced" in err


def test_cuda_activity_only_for_cuda_work(tmp_path, monkeypatch):
    """CPU work traces the host alone (no CUDA activity is asked for)."""
    import torch.profiler
    seen = []
    real = torch.profiler.profile

    def spy(*a, **kw):
        seen.append(list(kw.get("activities", [])))
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "profile", spy)
    monkeypatch.setenv("RTC_PROFILE_DIR", str(tmp_path / "prof"))
    with profiling.maybe_trace("cpu phase", CPU):
        torch.ones(4).sum()
    assert seen == [[torch.profiler.ProfilerActivity.CPU]]
    assert _dirs(tmp_path / "prof") == ["cpu_phase"]
