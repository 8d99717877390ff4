"""The port's state-file and RepDB arms of clust-mst and clust-greedy on
the CPU (``main(argv, device=cpu)``) against the JAX package's CLIs in the
same process: every ``--db`` verb (``--build``, ``--query``, ``--query
--device``, ``--assign``, ``--stats``, ``--append``) of the greedy KSSD,
MST KSSD, MST MinHash and MinHash greedy RepDBs, ``--buildDB`` from a list
and from a ``.cluster`` file, each ``--save-rep`` writer and each
``--append`` arm.  Each side runs the same steps in a working directory of
its own; everything they write there (``.cluster`` and TSV files, RepDB
and state files, run folders, ``--stats``' report) must be byte-equal.

The JAX side runs with RTC_MESH=0 (the conftest's 8 virtual CPU devices
would otherwise select its mesh ring)."""

import os

import pytest
import torch

from rabbittclust_tpu.cli.clust_greedy import main as jax_greedy_main
from rabbittclust_tpu.cli.clust_mst import main as jax_mst_main
from rabbittclust_tpu_torch.cli.clust_greedy import main as port_greedy_main
from rabbittclust_tpu_torch.cli.clust_mst import main as port_mst_main
from rabbittclust_tpu_torch.ops import bitmap as port_bm
from rabbittclust_tpu_torch.ops import engine as port_engine
from rabbittclust_tpu_torch.state import greedy_state as port_state

CPU = torch.device("cpu")
MAINS = {("jax", "mst"): jax_mst_main, ("jax", "greedy"): jax_greedy_main,
         ("port", "mst"): port_mst_main,
         ("port", "greedy"): port_greedy_main}
KSSD = ["--fast", "--drlevel", "2", "-m", "1000", "-d", "0.05"]
MINHASH = ["-m", "1000", "-d", "0.05", "-s", "300"]


@pytest.fixture(scope="module")
def lists(synthetic_genomes, tmp_path_factory):
    """``build.list``: copies 0-2 of clusters 0-2; ``add.list``: their
    copies 3-4 and all of cluster 3 (a cluster the state has not seen)."""
    d = tmp_path_factory.mktemp("repdb_lists")
    files = synthetic_genomes.files
    build = [f for f in files if f.rsplit("_", 1)[1][0] in "012"
             and not os.path.basename(f).startswith("g3_")]
    add = [f for f in files if f not in build]
    out = {}
    for name, fs in (("build", build), ("add", add)):
        out[name] = str(d / f"{name}.list")
        with open(out[name], "w") as f:
            f.write("\n".join(fs) + "\n")
    return out


class Side:
    """One CLI side's steps, each in ``root/<step dir>`` (run folders are
    named by the clock, so each run that makes one gets a directory)."""

    def __init__(self, side, root, monkeypatch, capsys):
        self.side, self.root = side, root
        self.mp, self.capsys = monkeypatch, capsys
        root.mkdir(parents=True)

    def __call__(self, module, argv, where=".", stdout=None):
        wd = self.root / where
        wd.mkdir(parents=True, exist_ok=True)
        self.mp.chdir(wd)
        kw = {"device": CPU} if self.side == "port" else {}
        self.capsys.readouterr()
        assert MAINS[self.side, module](list(argv), **kw) == 0, argv
        if stdout:
            (wd / stdout).write_text(self.capsys.readouterr().out)
        self.mp.chdir(self.root)

    def folder(self, where):
        """The one run folder made in ``where``."""
        runs = [p for p in (self.root / where).iterdir()
                if p.is_dir() and p.name.startswith("20")]
        assert len(runs) == 1, runs
        return str(runs[0])


def _tree(root):
    """Every file under ``root`` by path, run folders by their order."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        rel = [("RUN" if part.startswith("20") else part) for part in
               os.path.relpath(dirpath, root).split(os.sep) if part != "."]
        for name in filenames:
            with open(os.path.join(dirpath, name), "rb") as f:
                out["/".join(rel + [name])] = f.read()
    return out


def _spy(monkeypatch, module, name):
    """The arguments of each call of ``module.name`` (looked up at each
    call), calling through."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


def _both(tmp_path, monkeypatch, capsys, steps):
    """Run ``steps(side)`` for the JAX CLI, then the port's; their trees
    must be equal; returns the port's."""
    monkeypatch.setenv("RTC_MESH", "0")
    trees = {}
    for name in ("jax", "port"):
        side = Side(name, tmp_path / name, monkeypatch, capsys)
        steps(side)
        trees[name] = _tree(side.root)
    assert sorted(trees["jax"]) == sorted(trees["port"])
    for path, data in trees["jax"].items():
        assert trees["port"][path] == data, path
    return trees["port"]


@pytest.mark.parametrize("flavor", ["kssd", "minhash"])
def test_greedy_repdb_verbs_equal_jax(flavor, lists, tmp_path, monkeypatch,
                                      capsys):
    """clust-greedy --db: --build, --query (the port's KSSD --query takes
    the device probe, K1's plain version, with or without --device; the
    JAX CLI's only under --device), --assign, --stats and --append; the
    KSSD RepDB also built --presketched."""
    base = ["--fast", "--drlevel", "2", "-m", "1000"] if flavor == "kssd" \
        else ["-m", "1000", "-s", "300"]
    query = ["-i", lists["add"], "-l"]

    def steps(run):
        run("greedy", base + ["--db", "rep.db", "--build", "-i",
                              lists["build"], "-l", "-o", "build.cluster"])
        run("greedy", base + ["--db", "rep.db", "--query", "--top-k", "3",
                              "-o", "q.tsv"] + query)
        run("greedy", base + ["--db", "rep.db", "--query", "--device",
                              "--top-k", "3", "-o", "qd.tsv"] + query)
        run("greedy", base + ["--db", "rep.db", "--assign", "-o",
                              "a.tsv"] + query)
        run("greedy", base + ["--db", "rep.db", "--stats"],
            stdout="stats.txt")
        run("greedy", base + ["--db", "rep.db", "--append", lists["add"],
                              "-l", "-o", "app.cluster"])
        run("greedy", base + ["--db", "rep.db", "--stats"],
            stdout="stats_after.txt")
        if flavor == "kssd":
            run("mst", ["--fast", "--buildDB", "sk", "-l", "-i",
                        lists["build"], "-m", "1000", "--drlevel", "2"])
            run("greedy", base + ["--db", "pre.db", "--build",
                                  "--presketched", "sk", "-o",
                                  "pre.cluster"])

    k1 = _spy(monkeypatch, port_bm, "batched_mask")
    probes = _spy(monkeypatch, port_state, "batch_query_device")
    tree = _both(tmp_path, monkeypatch, capsys, steps)
    assert tree["q.tsv"] == tree["qd.tsv"]
    # the 5 genomes of cluster 3 match no representative
    assert tree["q.tsv"].count(b"\tno_match\t") == 5
    assert tree["q.tsv"].count(b"\n") > 11
    assert b"novel" in tree["a.tsv"] and b"\tassigned\n" in tree["a.tsv"]
    assert b"RepDB Statistics Report" in tree["stats.txt"]
    assert tree["stats.txt"] != tree["stats_after.txt"]
    # both of the port's KSSD --query runs went through K1 (its plain
    # version); the MinHash verbs run on the host
    assert bool(k1) == (flavor == "kssd")
    assert len(probes) == (2 if flavor == "kssd" else 0)
    if flavor == "kssd":
        assert tree["pre.db"][:8] == b"REPDB002"


@pytest.mark.parametrize("device", [False, True],
                         ids=["host-build", "device-build"])
@pytest.mark.parametrize("flavor", ["kssd", "minhash"])
def test_mst_repdb_verbs_equal_jax(flavor, device, lists, tmp_path,
                                   monkeypatch, capsys):
    """clust-mst --db: --build (the port's dense engine with or without
    --device; the JAX CLI's host compute_mst without it), --query,
    --assign, --stats and --append over the tree-medoid state."""
    base = (["--fast", "--drlevel", "2", "-m", "1000"] if flavor == "kssd"
            else ["-m", "1000", "-s", "300"])
    dev = ["--device"] if device else []

    def steps(run):
        run("mst", base + dev + ["--db", "mst.db", "--build", "-i",
                                 lists["build"], "-l", "-o",
                                 "build.cluster"])
        run("mst", base + ["--db", "mst.db", "--query", "-o", "q.tsv",
                           "-i", lists["add"], "-l"])
        run("mst", base + ["--db", "mst.db", "--assign", "-o", "a.tsv",
                           "-i", lists["add"], "-l"])
        run("mst", base + ["--db", "mst.db", "--stats"], stdout="stats.txt")
        run("mst", base + ["--db", "mst.db", "--append", lists["add"],
                           "-l", "-o", "app.cluster"])

    calls = _spy(monkeypatch, port_engine, "pair_mask_tiles")
    tree = _both(tmp_path, monkeypatch, capsys, steps)
    assert calls  # the dense engine's K4 (mask mode)
    assert tree["mst.db"][:9] == (b"KSMSTST01" if flavor == "kssd"
                                  else b"MHMSTST01")
    assert b"MST RepDB stats" in tree["stats.txt"]
    assert tree["build.cluster"].count(b"the cluster") == 3
    assert tree["app.cluster"].count(b"the cluster") == 4


@pytest.mark.parametrize("source", ["list", "cluster"])
def test_build_db_equal_jax(source, lists, tmp_path, monkeypatch, capsys):
    """--buildDB from a genome list, and from a .cluster file (the genome
    paths of its rows; the list it materializes is kept in the folder)."""
    def steps(run):
        inp = lists["build"]
        if source == "cluster":
            run("mst", KSSD + ["--device", "-e", "-l", "-i", lists["build"],
                               "-o", "in.cluster"])
            inp = "in.cluster"
        run("mst", ["--fast", "--buildDB", "db", "-l", "-i", inp,
                    "-m", "1000", "--drlevel", "2"])

    tree = _both(tmp_path, monkeypatch, capsys, steps)
    assert {"db/kssd.hash.sketch", "db/kssd.sketch.index"} <= set(tree)
    assert ("db/builddb.list" in tree) == (source == "cluster")


SAVE_REP = {
    "kssd-greedy": ("greedy", KSSD, "cluster_state.bin"),
    "kssd-mst": ("mst", KSSD, "mst_cluster_state.bin"),
    "minhash-greedy": ("greedy", MINHASH, "cluster_state.bin"),
}


@pytest.mark.parametrize("arm", list(SAVE_REP))
def test_save_rep_writers_equal_jax(arm, lists, tmp_path, monkeypatch,
                                    capsys):
    module, base, name = SAVE_REP[arm]

    def steps(run):
        run(module, base + ["--device", "--save-rep", "-l", "-i",
                            lists["build"], "-o", "out.cluster"])

    tree = _both(tmp_path, monkeypatch, capsys, steps)
    assert f"RUN/{name}" in tree


APPEND = {
    # (module, flags, --save-rep on the source run, state file)
    "kssd-mst-state": ("mst", KSSD, True, "mst_cluster_state.bin"),
    "kssd-greedy-state": ("greedy", KSSD, True, "cluster_state.bin"),
    "kssd-greedy": ("greedy", KSSD, False, None),
    "minhash-mst-state": ("mst", MINHASH, False, "mst_cluster_state.bin"),
    "minhash-mst": ("mst", MINHASH, False, None),
    "minhash-greedy-state": ("greedy", MINHASH, True, "cluster_state.bin"),
    "minhash-greedy": ("greedy", MINHASH, False, None),
}


@pytest.mark.parametrize("arm", list(APPEND))
def test_append_arms_equal_jax(arm, lists, tmp_path, monkeypatch, capsys):
    """Each --append arm over a source run folder of build.list: through
    the saved state (re-saved in the source folder: under --save-rep, and
    always by the KSSD clust-mst append), or classic (the MinHash clust-mst
    append on the port's dense engine with start_index and the saved
    edges; the greedy KSSD append builds its state from the folder and,
    under --save-rep, saves it there).  The classic MinHash appends leave
    the source folder as it was.  Only they run on the device engines:
    the host appends are given no --device."""
    module, base, save_rep, state = APPEND[arm]
    dev = ["--device"] if arm in ("minhash-mst", "minhash-greedy") else []

    def steps(run):
        run(module, base + ["--device", "-l", "-i", lists["build"], "-o",
                            "src.cluster"] + (["--save-rep"] if save_rep
                                              else []), where="src")
        src = run.folder("src")
        if arm == "minhash-mst-state":
            # a MinHash tree-medoid state is made by the MST RepDB build
            run("mst", base + ["--db", os.path.join(src, state), "--build",
                               "--presketched", src, "-o", "db.cluster"],
                where="src")
        before = _tree(src)
        run(module, base + dev + ["--presketched", src, "--append",
                                  lists["add"], "-l", "-o", "app.cluster",
                                  "--save-rep"], where="app")
        if arm in ("minhash-mst", "minhash-greedy"):
            assert _tree(src) == before

    k4 = _spy(monkeypatch, port_engine, "pair_mask_tiles")
    tree = _both(tmp_path, monkeypatch, capsys, steps)
    if state:
        assert f"src/RUN/{state}" in tree
    if arm == "minhash-mst":
        # K4's mask mode over two planes ran from the first new genome
        assert (True, 9) in {(a[1] is not None, a[7]) for a in k4}
        assert "app/RUN/edge.mst" in tree
    assert tree["app/app.cluster"].count(b"the cluster") == 4
