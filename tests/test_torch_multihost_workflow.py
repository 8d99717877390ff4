"""The port's ``--multihost`` CLIs end to end on CPU shards: N processes
started by ``parallel/launch.py`` (``RTC_VIRTUAL_CPU_DEVICES=2``), each
sketching only its block of the genome list, must write a ``.cluster``
file byte-identical to the JAX CLI's single-host run at ``-t 2`` (the
deterministic (distance, id) tie order the merged Kruskal keeps), as
``tests/test_multihost_workflow.py`` holds the JAX package's own
multi-process run; and the RepDB serving path (``--db --query/--assign
--multihost``), each rank probing its block of the queries."""

import os
import signal
import subprocess
import sys

import pytest
import torch

from rabbittclust_tpu_torch.parallel import launch as pl
from rabbittclust_tpu_torch.parallel.multihost import RanksTimedOut, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _single_host_cluster(list_file, out, module="mst", extra=(),
                         threads="2"):
    """The JAX CLI's single-host run (``-e``, ``-t 2`` by default)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["RTC_PLATFORM"] = "cpu"
    thr = (("--eps", "0.05") if module == "dbscan" else ("-d", "0.05"))
    r = subprocess.run(
        [sys.executable, "-m", f"rabbittclust_tpu.cli.clust_{module}",
         "--fast", "-l", "-i", list_file, "-o", out, *thr,
         "-m", "1000", "-e", "-t", threads, *extra],
        capture_output=True, text=True, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return open(out).read()


@pytest.fixture(scope="module")
def jittered_genomes(tmp_path_factory):
    """Length-jittered corpus: distinct distances, so byte equality is
    well defined (tests/test_multihost_workflow.py's corpus)."""
    from helpers import make_clustered_genomes
    tmp = str(tmp_path_factory.mktemp("jit_genomes"))
    return make_clustered_genomes(tmp, length_jitter=3000, seed=11)


@pytest.mark.parametrize("module,nproc", [("mst", 2), ("greedy", 2),
                                          ("leiden", 3), ("dbscan", 2)])
def test_multihost_cli_byte_equal_single_host(tmp_path, jittered_genomes,
                                              module, nproc):
    single = str(tmp_path / f"single_{module}.cluster")
    multi = str(tmp_path / f"multi_{module}.cluster")
    extra = ("--knn", "0") if module == "leiden" else \
        ("--minpts", "3") if module == "dbscan" else ()
    want = _single_host_cluster(jittered_genomes.list_file, single, module,
                                extra)
    thr = (("--eps", "0.05") if module == "dbscan" else ("-d", "0.05"))
    rc = pl.launch(nproc, ["--fast", "-l", "-i", jittered_genomes.list_file,
                           "-o", multi, *thr, "-m", "1000", "-t", "1",
                           *extra],
                   module=module, virtual_cpu_devices=2, timeout=600.0)
    assert rc == 0
    assert open(multi).read() == want, \
        f"{module}: multihost .cluster != single-host"


def _parse_partition(text):
    out = []
    for block in text.split("the cluster ")[1:]:
        ids = [int(line.split("\t")[2]) for line in block.splitlines()[1:]
               if "\t" in line]
        out.append(tuple(sorted(ids)))
    return sorted(out)


def test_multihost_mst_tie_corpus(tmp_path, synthetic_genomes):
    """Equal-length genomes: masses of distance ties.  Byte equality holds
    against the deterministic -t 2 order; against -t 1 (the reference's
    introsort order) only the partition."""
    multi = str(tmp_path / "multi.cluster")
    want = _single_host_cluster(synthetic_genomes.list_file,
                                str(tmp_path / "single.cluster"))
    rc = pl.launch(2, ["--fast", "-l", "-i", synthetic_genomes.list_file,
                       "-o", multi, "-d", "0.05", "-m", "1000", "-t", "1"],
                   module="mst", virtual_cpu_devices=2, timeout=600.0)
    assert rc == 0
    got = open(multi).read()
    assert got == want
    t1 = _single_host_cluster(synthetic_genomes.list_file,
                              str(tmp_path / "t1.cluster"), threads="1")
    assert _parse_partition(got) == _parse_partition(t1)


def test_module_entry_byte_equal(tmp_path, jittered_genomes):
    """``python -m rabbittclust_tpu_torch.workflows_dist`` (one rank a
    process, ``--virtual-cpu-devices``) writes the CLI's file."""
    from rabbittclust_tpu_torch.parallel.multihost import free_port, run_ranks
    want = _single_host_cluster(jittered_genomes.list_file,
                                str(tmp_path / "single.cluster"))
    out = str(tmp_path / "entry.cluster")
    coord = f"127.0.0.1:{free_port()}"
    rcs, _, errs = run_ranks(
        [[sys.executable, "-m", "rabbittclust_tpu_torch.workflows_dist",
          "--multihost", f"{coord},2,{pid}", "-l", "-i",
          jittered_genomes.list_file, "-o", out, "-m", "1000",
          "--virtual-cpu-devices", "1"] for pid in range(2)],
        timeout=600, cwd=REPO)
    assert rcs == [0, 0], errs
    assert open(out).read() == want


@pytest.mark.parametrize("verb", ["--query", "--assign"])
def test_multihost_repdb_byte_equal_single_host(verb, tmp_path,
                                                jittered_genomes):
    """``clust-greedy --fast --db --query/--assign --multihost`` with 2
    ranks, each probing its block of the queries: the TSV byte-equal to
    the single-process verb's, the port's and the JAX CLI's."""
    from rabbittclust_tpu.cli.clust_greedy import main as jax_main
    from rabbittclust_tpu_torch.cli.clust_greedy import main as port_main
    files = jittered_genomes.files
    lists = {}
    for name, part in (("build", files[::2]), ("query", files)):
        lists[name] = str(tmp_path / f"{name}.list")
        with open(lists[name], "w") as f:
            f.write("\n".join(part) + "\n")
    db = str(tmp_path / "rep.db")
    base = ["--fast", "--db", db, "-m", "1000", "-l"]
    assert port_main(base + ["--build", "-i", lists["build"], "-o",
                             str(tmp_path / "db.cluster")]) == 0
    outs = {}
    # the port's single-process --query probes on the CLI's device (K1's
    # plain version on the CPU); the ranks probe on the host
    for side, fn, kw in (("jax", jax_main, {}),
                         ("port", port_main, {"device": torch.device("cpu")})):
        outs[side] = str(tmp_path / f"{side}.tsv")
        assert fn(base + [verb, "--top-k", "3", "-i", lists["query"], "-o",
                          outs[side]], **kw) == 0
    multi = str(tmp_path / "multi.tsv")
    rc = pl.launch(2, base + [verb, "--top-k", "3", "-i", lists["query"],
                              "-o", multi],
                   module="greedy", virtual_cpu_devices=1, timeout=600.0)
    assert rc == 0
    want = open(outs["jax"]).read()
    assert open(outs["port"]).read() == want
    assert open(multi).read() == want
    assert want.count("\n") > len(files)  # hits of several reps a query


def test_launch_kills_every_child_at_its_timeout(tmp_path, monkeypatch,
                                                 jittered_genomes):
    timeouts = []

    def spy(*args, **kwargs):
        try:
            return run_ranks(*args, **kwargs)
        except RanksTimedOut as exc:
            timeouts.append(exc)
            raise
    monkeypatch.setattr(pl, "run_ranks", spy)
    rc = pl.launch(2, ["--fast", "-l", "-i", jittered_genomes.list_file,
                       "-o", str(tmp_path / "o.cluster"), "-m", "1000"],
                   module="mst", virtual_cpu_devices=2, timeout=0.5)
    assert rc == 124
    # run_ranks killed and reaped both ranks
    assert [exc.returncodes for exc in timeouts] == [[-signal.SIGKILL] * 2]
    assert not (tmp_path / "o.cluster").exists()
