"""The port's spans and counters (``utils/profiling.py``) on the CPU: the
job scope of ``compute_kssd_clusters``, parents and self times, the
engines' ``LP_STATS`` and ``stats`` keys as span totals, and the ranges a
``torch.profiler`` session sees, which the benchmark's trace reading names
idle gaps by."""

import os
import time
from contextlib import contextmanager

import pytest
import torch

from portbench import harness
from portbench import trace as bench_trace
from rabbittclust_tpu_torch import workflows
from rabbittclust_tpu_torch.ops import labelprop as port_lp
from rabbittclust_tpu_torch.parallel import dist_engine
from rabbittclust_tpu_torch.sketch.base import SketchSet
from rabbittclust_tpu_torch.sketch.kssd import KssdParams
from rabbittclust_tpu_torch.utils import profiling
from torch_port_data import clustered_sketches

CPU = torch.device("cpu")
PARAMS = KssdParams.from_kmer_size(21, 3)

LP_KEYS = {"pack_s": "lp.pack", "stage_s": "lp.upload", "csr_s": "lp.csr",
           "pull_s": "lp.pull", "verify_s": "lp.verify",
           "finish_s": "lp.finish"}
DENSE_KEYS = {"pack_s": "dense.pack", "h2d_s": "dense.upload",
              "compact_s": "dense.compact", "dispatch_s": "dense.dispatch",
              "sweep_wait_s": "dense.sweep_wait", "decode_s": "dense.decode",
              "pair_common_s": "dense.pair_common", "edges_s": "dense.edges",
              "kruskal_s": "dense.kruskal"}
# the mesh engine's span readers (portbench/metrics) and their spans
MESH_READERS = {"mesh.pack_s": "mesh.pack", "mesh.ring_s": "mesh.ring",
                "mesh.step_wait_s": "mesh.step_wait",
                "mesh.decode_s": "mesh.decode",
                "mesh.kruskal_s": "mesh.kruskal"}
MESH_SPANS = set(MESH_READERS.values()) | {"mesh.upload", "mesh.hop"}
MESH_METRICS = sorted(MESH_READERS) + ["mesh.candidates",
                                       "mesh.card_peak_gib"]


def sketch_set(n):
    ss = SketchSet("kssd", PARAMS, True, PARAMS.use64)
    for i, h in enumerate(clustered_sketches(n=n, n_clusters=8)):
        ss.append_genome(file_name=f"g{i}.fna", name=f"g{i}", comment="",
                         seq0_len=1000, total_len=1000, num_seqs=1,
                         hashes=h)
    return ss


def run_job(tmp_path, engine, n=120):
    """One ``compute_kssd_clusters`` call as ``clust-mst --device``:
    ``-e`` (``lp``) or the MST saved (``dense``); (stats, clusters)."""
    stats = {}
    opts = workflows.OutputOptions(use_device=True,
                                   no_save=engine == "lp")
    clusters, _ = workflows.compute_kssd_clusters(
        sketch_set(n), PARAMS, 0.05, str(tmp_path / "out.cluster"), False,
        opts, str(tmp_path / "run"), CPU, stats=stats, threads=2)
    return stats, clusters


@pytest.fixture
def jobs_seen(monkeypatch):
    """The ``Job`` of every job scope ``compute_kssd_clusters`` opens."""
    seen = []
    real = profiling.job

    @contextmanager
    def spy(stats):
        with real(stats) as j:
            seen.append(j)
            yield j
    monkeypatch.setattr(workflows, "job", spy)
    return seen


@pytest.fixture
def small_lp(monkeypatch):
    monkeypatch.setenv("RTC_CLUSTER_ENGINE", "lp")
    monkeypatch.setenv("RTC_CLUSTER_BITS", "2048")


def test_spans_nest_under_one_job_each(tmp_path, small_lp, jobs_seen):
    run_job(tmp_path, "lp")
    run_job(tmp_path, "lp")
    assert len(jobs_seen) == 2 and jobs_seen[0].id != jobs_seen[1].id
    for j in jobs_seen:
        recs = {sid: (parent, job_id, name)
                for sid, parent, job_id, name, _, _ in j.spans}
        assert {job_id for _, job_id, _ in recs.values()} == {j.id}
        roots = [name for parent, _, name in recs.values() if parent == 0]
        assert roots == ["job"]

        def path(sid):
            parent, _, name = recs[sid]
            return path(parent) + [name] if parent else [name]
        paths = {tuple(path(sid)) for sid in recs}
        assert ("job", "mst_free.clusters", "lp.engine", "lp.panel",
                "lp.csr") in paths
        assert ("job", "mst_free.clusters", "lp.engine", "lp.pack") in paths
        assert ("job", "write.cluster") in paths
    assert profiling._JOB is None


def test_self_time_is_the_total_less_the_childrens_cover():
    j = profiling.Job()
    j.spans += [
        (2, 1, j.id, "b", 100, 300),
        (4, 2, j.id, "d", 150, 200),  # a grandchild: not a's child
        (3, 1, j.id, "c", 250, 500),  # overlaps b: covered once
        (5, 1, j.id, "c", 900, 1200),  # ends after its parent: clipped
        (1, 0, j.id, "a", 0, 1000),
    ]
    s = j.summary()
    assert s["a"]["n"] == 1
    assert s["a"]["total_s"] == pytest.approx(1000e-9)
    assert s["a"]["self_s"] == pytest.approx((1000 - 400 - 100) * 1e-9)
    assert s["b"]["self_s"] == pytest.approx(150e-9)
    assert s["c"]["n"] == 2 and s["c"]["total_s"] == pytest.approx(550e-9)
    assert s["c"]["self_s"] == pytest.approx(550e-9)


def test_without_a_job_scope_nothing_is_recorded():
    assert profiling._JOB is None
    profiling.count("lp.kept", 3)  # no job: a no-op
    stats = {}
    with profiling.span("outside", stats, "outside_s") as sp:
        time.sleep(0.002)
    assert sp.seconds >= 0.002 and stats["outside_s"] == sp.seconds
    job_stats = {}
    with profiling.job(job_stats) as j:
        profiling.count("inside", 2)
        with profiling.span("inside"):
            pass
    assert [r[3] for r in j.spans] == ["inside", "job"]
    assert job_stats["counters"] == {"inside": 2}
    assert set(job_stats["spans"]) == {"inside", "job"}
    with profiling.job(None) as none:
        profiling.count("lost")
    assert none is None and profiling._JOB is None


def test_lp_job_fills_spans_counters_and_lp_stats(tmp_path, small_lp):
    stats, clusters = run_job(tmp_path, "lp", n=160)
    spans, counters = stats["spans"], stats["counters"]
    for key, name in LP_KEYS.items():
        assert port_lp.LP_STATS[key] == spans[name]["total_s"], key
    assert port_lp.LP_STATS["total_s"] == spans["lp.engine"]["total_s"]
    assert spans["lp.round"]["n"] == port_lp.LP_STATS["rounds"]
    assert spans["lp.panel"]["n"] == port_lp.LP_STATS["panels"]
    assert counters["lp.proposals"] == port_lp.LP_STATS["proposals"]
    # the kept edges span the clusters (no fallback ran)
    assert "lp.fallback" not in spans
    assert counters["lp.kept"] == 160 - len(clusters)
    assert stats["clusters_s"] == spans["mst_free.clusters"]["total_s"]
    for name, agg in spans.items():
        assert 0.0 <= agg["self_s"] <= agg["total_s"], name


def test_lp_panels_and_fallback_under_a_job_scope():
    """The engine called alone inside a job scope: several panels (the
    compact pull) and the host finish after ``max_rounds``."""
    hashes = clustered_sketches(n=300, s=120, n_clusters=9, seed=13,
                                keep=0.8)
    stats = {}
    with profiling.job(stats):
        port_lp.threshold_clusters_device_lp(
            hashes, 0.05, 21, bits=2048, row_block=64, panel_tiles=4,
            max_rounds=1, device=CPU)
    spans = stats["spans"]
    assert spans["lp.panel"]["n"] == port_lp.LP_STATS["panels"] > 1
    assert spans["lp.fallback"]["n"] >= 1
    assert spans["lp.build"]["n"] == port_lp.LP_STATS["panels"]
    for key, name in LP_KEYS.items():
        assert port_lp.LP_STATS[key] == spans[name]["total_s"], key


def test_dense_job_fills_spans_and_engine_stats(tmp_path, monkeypatch):
    monkeypatch.setenv("RTC_MESH", "0")
    stats, _ = run_job(tmp_path, "dense")
    spans = stats["spans"]
    for key, name in DENSE_KEYS.items():
        assert stats[key] == spans[name]["total_s"], key
    assert stats["mst_s"] == spans["mst.compute"]["total_s"]
    assert stats["outputs_s"] == spans["mst.outputs"]["total_s"]
    for name in ("mst.save", "mst.cut", "write.cluster"):
        assert spans[name]["n"] == 1, name
    # the Kruskal passes take every candidate once, and each budget flush
    # hands its forest (at most n - 1 edges) to the next pass
    assert set(stats["counters"]) == {"mst.kruskal_edges"}
    flushes = spans["dense.kruskal"]["n"] - 1
    assert flushes >= 1
    assert (stats["candidates"] < stats["counters"]["mst.kruskal_edges"]
            <= stats["candidates"] + flushes * (120 - 1))
    outputs = spans["mst.outputs"]
    assert outputs["self_s"] < outputs["total_s"]
    assert os.path.exists(tmp_path / "run" / "edge.mst")


def run_of(*stats):
    """A benchmark ``Run`` whose window holds a job of each ``stats``."""
    return harness.Run(config={}, traffic={}, corpus=None, jobs=[
        {"wall_s": 1.0, "stats": st, "lp_stats": {"panels": 0}}
        for st in stats])


def test_mesh_job_fills_spans_and_counters(tmp_path, monkeypatch):
    """``clust-mst --device`` with ``edge.mst`` saved over four shards:
    the exact ring's spans, each ring step's wait, and the counters the
    benchmark's mesh metrics read."""
    monkeypatch.delenv("RTC_MESH", raising=False)
    monkeypatch.setattr(workflows, "mesh_devices",
                        lambda device: [device] * 4)
    given = []
    real = dist_engine.kruskal

    def spy(e, n, *args, **kw):
        given.append(len(e[0]))
        return real(e, n, *args, **kw)
    monkeypatch.setattr(dist_engine, "kruskal", spy)
    stats, _ = run_job(tmp_path, "dense")
    spans, counters = stats["spans"], stats["counters"]
    assert MESH_SPANS <= set(spans)
    assert not [name for name in spans if name.startswith("dense.")]
    for name in ("mesh.pack", "mesh.upload", "mesh.ring", "mesh.decode",
                 "mesh.kruskal"):
        assert spans[name]["n"] == 1, name
    assert spans["mesh.hop"]["n"] == 2  # 3 steps on 4 shards
    assert spans["mesh.step_wait"]["n"] == 12
    assert spans["mesh.ring"]["total_s"] >= (
        spans["mesh.step_wait"]["total_s"] + spans["mesh.hop"]["total_s"])
    assert counters["mesh.cards"] == 4 and counters["mesh.steps"] == 12
    assert given == [counters["mesh.candidates"]]
    assert counters["mesh.candidates"] == counters["mst.kruskal_edges"]
    # one device and no card: no hop crosses, no card's peak is read
    assert "mesh.hop_bytes" not in counters
    assert "mesh.card_peak_bytes" not in counters

    run = run_of(stats)
    for metric, name in MESH_READERS.items():
        assert harness.read_metric(metric, run) == spans[name]["total_s"]
    assert harness.read_metric("mesh.candidates", run) == \
        counters["mesh.candidates"]
    assert harness.read_metric("mesh.card_peak_gib", run) is None


@pytest.mark.parametrize("metric", MESH_METRICS)
def test_mesh_readers_find_nothing_without_the_mesh(metric, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("RTC_MESH", "0")
    stats, _ = run_job(tmp_path, "dense", n=40)
    assert harness.read_metric(metric, run_of(stats, {})) is None


def test_card_peak_reader_means_the_jobs_that_counted_it():
    jobs = [{"counters": {"mesh.card_peak_bytes": 3 * 2 ** 30}},
            {"counters": {"mesh.card_peak_bytes": 2 ** 30}},
            {"counters": {}}, {}]
    assert harness.read_metric("mesh.card_peak_gib", run_of(*jobs)) == 2.0


def test_hop_bytes_count_what_crosses_devices():
    """The default shift counts a shard's bytes only where it moves to
    another device: here shard 0 onto the ``meta`` device."""
    mesh = dist_engine.Mesh((CPU, torch.device("meta")))

    def shard(lo):
        return dist_engine.BitShard(torch.zeros((8, 1024), dtype=torch.uint8),
                                    torch.zeros(8, dtype=torch.int32),
                                    torch.zeros(8, dtype=torch.int32), lo)
    shards = [shard(0), shard(8)]
    stats = {}
    with profiling.job(stats):
        dist_engine._ring(mesh, shards, lambda d, t, loc, vis: vis.lo)
    assert stats["counters"] == {"mesh.steps": 4,
                                 "mesh.hop_bytes": 8 * 1024 + 2 * 8 * 4}
    assert stats["spans"]["mesh.hop"]["n"] == 1


def test_spans_are_ranges_of_a_profiler_session(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.job"):
            with profiling.span("outer"):
                torch.ones(4).sum()
                with profiling.span("lp.csr"):
                    time.sleep(0.05)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = bench_trace.load(path)
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"outer", "lp.csr"} <= names
    gaps = bench_trace.summarize(events, "portbench.job")["idle_gaps"]
    assert gaps[0][0] == "host lp.csr"


def test_no_range_is_entered_without_a_session(tmp_path, small_lp,
                                               monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) outside a session")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    stats, _ = run_job(tmp_path, "lp")
    assert "lp.verify" in stats["spans"]
