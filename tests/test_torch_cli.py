"""The port's clust-mst, clust-greedy, clust-dbscan and clust-leiden CLIs
on the CPU
(``main(argv, device=cpu)``) against the JAX package's CLIs: cluster files,
trees, sketch folders and edge.mst byte-equal.

The JAX side runs with RTC_MESH=0 (the conftest's 8 virtual CPU devices
would otherwise select the mesh ring).  The dense-engine tests set
RTC_MST_CLUSTERS_FAST=0 for both CLIs (``-e`` then keeps the dense MST
engine); the MST-free tests leave it unset, the default, and pin the JAX
stream engine to packed-mask pulls (RTC_PULL_MODE=mask), the port's only
pull."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from rabbittclust_tpu.cli.clust_dbscan import main as jax_dbscan_main
from rabbittclust_tpu.cli.clust_greedy import main as jax_greedy_main
from rabbittclust_tpu.cli.clust_leiden import main as jax_leiden_main
from rabbittclust_tpu.cli.clust_mst import main as jax_main
from rabbittclust_tpu_torch.cli.clust_dbscan import main as port_dbscan_main
from rabbittclust_tpu_torch.cli.clust_greedy import main as port_greedy_main
from rabbittclust_tpu_torch.cli.clust_leiden import main as port_leiden_main
from rabbittclust_tpu_torch.cli.clust_mst import main as port_main

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


MAINS = {"greedy": (jax_greedy_main, port_greedy_main),
         "dbscan": (jax_dbscan_main, port_dbscan_main),
         "leiden": (jax_leiden_main, port_leiden_main)}


def _run_both(tmp_path, monkeypatch, argv, presketched=None,
              mst_free=False, greedy=False, module=None):
    """Run argv through both CLIs (clust-greedy's with ``greedy``, another
    command's with ``module``), each in its own working directory (run
    folders are named by the clock); returns {side: (out_dir, folder)}."""
    monkeypatch.setenv("RTC_MESH", "0")
    if mst_free:
        monkeypatch.delenv("RTC_MST_CLUSTERS_FAST", raising=False)
        monkeypatch.setenv("RTC_PULL_MODE", "mask")
    else:
        monkeypatch.setenv("RTC_MST_CLUSTERS_FAST", "0")
    res = {}
    jax_fn, port_fn = MAINS.get("greedy" if greedy else module,
                                (jax_main, port_main))
    mains = (("jax", jax_fn), ("port", port_fn))
    for side, fn in mains:
        wd = tmp_path / side
        wd.mkdir(parents=True)
        monkeypatch.chdir(wd)
        args = list(argv)
        if presketched is not None:
            folder = str(wd / "sketches")
            shutil.copytree(presketched, folder)
            args += ["--presketched", folder]
        kw = {"device": CPU} if side == "port" else {}
        assert fn(args + ["-o", str(wd / "out.cluster")], **kw) == 0
        runs = [p for p in wd.iterdir() if p.is_dir()]
        res[side] = (wd, runs[0] if len(runs) == 1 else None)
    return res


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _fresh_args(genomes):
    return ["--fast", "--device", "-l", "-i", genomes.list_file, "-d",
            "0.05", "--drlevel", "2", "-m", "1000"]


def test_cli_default_saves_byte_equal(synthetic_genomes, tmp_path,
                                      monkeypatch):
    res = _run_both(tmp_path, monkeypatch, _fresh_args(synthetic_genomes))
    (jw, jf), (pw, pf) = res["jax"], res["port"]
    assert _same_bytes(jw / "out.cluster", pw / "out.cluster")
    assert jf is not None and pf is not None
    names = sorted(p.name for p in jf.iterdir())
    assert names == sorted(p.name for p in pf.iterdir())
    assert "edge.mst" in names
    for name in names:
        assert _same_bytes(jf / name, pf / name), name


def test_cli_no_save_byte_equal(synthetic_genomes, tmp_path, monkeypatch):
    res = _run_both(tmp_path, monkeypatch,
                    _fresh_args(synthetic_genomes) + ["-e"])
    (jw, jf), (pw, pf) = res["jax"], res["port"]
    assert jf is None and pf is None  # nothing saved
    assert _same_bytes(jw / "out.cluster", pw / "out.cluster")


@pytest.mark.parametrize("threads", ["1", "2"])
def test_cli_mst_free_e_byte_equal(synthetic_genomes, tmp_path, monkeypatch,
                                   capsys, threads):
    """``-e`` with no MST consumer, the JAX CLI's default MST-free engine:
    ``-t 1`` the reference's serial member order, ``-t 2`` the BFS order of
    the verified forest."""
    res = _run_both(tmp_path, monkeypatch,
                    _fresh_args(synthetic_genomes) + ["-e", "-t", threads],
                    mst_free=True)
    # both CLIs took the MST-free engine
    assert capsys.readouterr().err.count("MST-free device cluster") == 2
    (jw, jf), (pw, pf) = res["jax"], res["port"]
    assert jf is None and pf is None  # nothing saved
    assert _same_bytes(jw / "out.cluster", pw / "out.cluster")
    with open(pw / "out.cluster") as f:
        assert f.read().count("the cluster") == 4


def test_cli_newick_tree_byte_equal(synthetic_genomes, tmp_path,
                                    monkeypatch):
    res = _run_both(tmp_path, monkeypatch,
                    _fresh_args(synthetic_genomes) + ["-e", "--newick-tree",
                                                      "--dense"])
    (jw, _), (pw, _) = res["jax"], res["port"]
    for name in ("out.cluster", "out.cluster.newick.tree",
                 "out.cluster.removeNoise"):
        assert _same_bytes(jw / name, pw / name), name


def test_cli_presketched_and_premsted_byte_equal(synthetic_genomes,
                                                 tmp_path, monkeypatch):
    first = _run_both(tmp_path / "fresh", monkeypatch,
                      _fresh_args(synthetic_genomes))
    folder = first["jax"][1]
    res = _run_both(tmp_path / "pre", monkeypatch,
                    ["--fast", "--device", "-d", "0.05"],
                    presketched=folder)
    (jw, _), (pw, _) = res["jax"], res["port"]
    assert _same_bytes(jw / "out.cluster", pw / "out.cluster")
    assert _same_bytes(jw / "sketches" / "edge.mst",
                       pw / "sketches" / "edge.mst")
    assert _same_bytes(folder / "edge.mst", pw / "sketches" / "edge.mst")
    # --premsted re-cuts the saved MST at another threshold, no device
    for side, fn in (("jax", jax_main), ("port", port_main)):
        wd = res[side][0]
        assert fn(["--fast", "--premsted", str(wd / "sketches"), "-d",
                   "0.03", "-o", str(wd / "re.cluster")]) == 0
    assert _same_bytes(jw / "re.cluster", pw / "re.cluster")


def _same_folders(a, b, names=None):
    """The two run folders hold the same files (or ``names``), byte-equal."""
    got = sorted(p.name for p in a.iterdir())
    assert got == sorted(p.name for p in b.iterdir())
    for name in names or got:
        assert _same_bytes(a / name, b / name), name


@pytest.mark.parametrize("mode", ["force", "auto"])
def test_cli_greedy_fast_byte_equal(synthetic_genomes, tmp_path, monkeypatch,
                                    capsys, mode):
    """clust-greedy --fast --device from genomes, then --presketched from
    the saved folder: ``force`` takes the device sweep (K1 under its greedy
    bound) on both sides, ``auto`` the native engine (below 16,384 genomes
    the density probe always routes there)."""
    monkeypatch.setenv("RTC_GREEDY_DEVICE", mode)
    fresh = _run_both(tmp_path / "fresh", monkeypatch,
                      _fresh_args(synthetic_genomes), greedy=True)
    (jw, jf), (pw, pf) = fresh["jax"], fresh["port"]
    assert _same_bytes(jw / "out.cluster", pw / "out.cluster")
    _same_folders(jf, pf)
    pre = _run_both(tmp_path / "pre", monkeypatch,
                    ["--fast", "--device", "-d", "0.05"], presketched=jf,
                    greedy=True)
    assert _same_bytes(pre["jax"][0] / "out.cluster",
                       pre["port"][0] / "out.cluster")
    with open(pw / "out.cluster") as f:
        assert f.read().count("the cluster") == 4
    routed = capsys.readouterr().err.count("dense corpus — routing")
    assert routed == (4 if mode == "auto" else 0)


def test_cli_greedy_minhash_byte_equal(synthetic_genomes, tmp_path,
                                       monkeypatch):
    """MinHash clust-greedy --device (containment by default) from genomes,
    then --presketched (length-sorted, the contain_compress param size)."""
    fresh = _run_both(tmp_path / "fresh", monkeypatch,
                      ["--device", "-l", "-i", synthetic_genomes.list_file,
                       "-d", "0.05", "-m", "1000"], greedy=True)
    (jw, jf), (pw, pf) = fresh["jax"], fresh["port"]
    assert _same_bytes(jw / "out.cluster", pw / "out.cluster")
    _same_folders(jf, pf)
    assert "minhash.sketch.index" in {p.name for p in pf.iterdir()}
    pre = _run_both(tmp_path / "pre", monkeypatch, ["--device", "-d", "0.05"],
                    presketched=jf, greedy=True)
    assert _same_bytes(pre["jax"][0] / "out.cluster",
                       pre["port"][0] / "out.cluster")


def test_cli_greedy_minhash_jaccard_byte_equal(synthetic_genomes, tmp_path,
                                               monkeypatch):
    """MinHash clust-greedy --device with a fixed sketch size (-s: the
    fast path, winner = max common)."""
    res = _run_both(tmp_path, monkeypatch,
                    ["--device", "-l", "-i", synthetic_genomes.list_file,
                     "-d", "0.05", "-k", "21", "-s", "300", "-m", "1000",
                     "-e"], greedy=True)
    assert _same_bytes(res["jax"][0] / "out.cluster",
                       res["port"][0] / "out.cluster")


def test_cli_minhash_mst_byte_equal(synthetic_genomes, tmp_path,
                                    monkeypatch):
    """MinHash clust-mst --device (the dense engine over two planes of
    64-bit hashes) from genomes, --presketched, and --premsted (which
    writes no threshold header)."""
    fresh = _run_both(tmp_path / "fresh", monkeypatch,
                      ["--device", "-l", "-i", synthetic_genomes.list_file,
                       "-d", "0.05", "-s", "300", "-m", "1000"])
    (jw, jf), (pw, pf) = fresh["jax"], fresh["port"]
    assert _same_bytes(jw / "out.cluster", pw / "out.cluster")
    _same_folders(jf, pf)
    assert {"edge.mst", "info.mst", "hash.sketch"} <= {
        p.name for p in pf.iterdir()}
    pre = _run_both(tmp_path / "pre", monkeypatch, ["--device", "-d", "0.05"],
                    presketched=jf)
    (jw2, _), (pw2, _) = pre["jax"], pre["port"]
    assert _same_bytes(jw2 / "out.cluster", pw2 / "out.cluster")
    _same_folders(jw2 / "sketches", pw2 / "sketches")
    for side, fn in (("jax", jax_main), ("port", port_main)):
        wd = pre[side][0]
        assert fn(["--premsted", str(wd / "sketches"), "-d", "0.03", "-o",
                   str(wd / "re.cluster")]) == 0
    assert _same_bytes(jw2 / "re.cluster", pw2 / "re.cluster")
    with open(pw2 / "re.cluster") as f:
        assert not f.readline().startswith("the threshold")


def _append_lists(genomes, tmp_path):
    init, app = tmp_path / "init.list", tmp_path / "app.list"
    init.write_text("\n".join(genomes.files[:8]) + "\n")
    app.write_text("\n".join(genomes.files[8:]) + "\n")
    return str(init), str(app)


def test_cli_append_byte_equal(synthetic_genomes, tmp_path, monkeypatch):
    """clust-mst --fast --device --append (classic mode): the dense engine
    over the tiles of the new genomes (start_index = 8), merged with the
    saved MST; .cluster and the new run folder byte-equal."""
    init, app = _append_lists(synthetic_genomes, tmp_path)
    first = _run_both(tmp_path / "init", monkeypatch,
                      ["--fast", "--device", "-l", "-i", init, "-d", "0.05",
                       "--drlevel", "2", "-m", "1000"])
    res = _run_both(tmp_path / "app", monkeypatch,
                    ["--fast", "--device", "--append", app, "-l", "-d",
                     "0.05", "-m", "1000"], presketched=first["jax"][1])
    folders = {}
    for side in ("jax", "port"):
        wd = res[side][0]
        new = [p for p in wd.iterdir() if p.is_dir() and p.name != "sketches"]
        assert len(new) == 1
        folders[side] = new[0]
    assert _same_bytes(res["jax"][0] / "out.cluster",
                       res["port"][0] / "out.cluster")
    _same_folders(folders["jax"], folders["port"])
    assert {"edge.mst", "kssd.hash.sketch", "kssd.sketch.index"} <= {
        p.name for p in folders["port"].iterdir()}


def test_classic_append_preserves_source_folder(synthetic_genomes, tmp_path,
                                                monkeypatch):
    """Classic append writes the merged files to a NEW timestamped run
    folder; the presketched source folder is never changed (reference
    append_clust_mst_fast, sub_command.cpp:1450-1470)."""
    import hashlib
    import time

    def folder_digest(d):
        return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
                for f in sorted(d.iterdir())}

    init, app = _append_lists(synthetic_genomes, tmp_path)
    monkeypatch.setenv("RTC_MST_CLUSTERS_FAST", "0")
    monkeypatch.chdir(tmp_path)
    assert port_main(["--fast", "--device", "-l", "-i", init, "-o",
                      str(tmp_path / "a.cluster"), "-d", "0.05"],
                     device=CPU) == 0
    runs = [p for p in tmp_path.iterdir() if p.name.startswith("20")]
    assert len(runs) == 1
    src = runs[0]
    before = folder_digest(src)
    time.sleep(1.1)  # distinct timestamp for the append's new folder
    assert port_main(["--fast", "--device", "--presketched", str(src),
                      "--append", app, "-l", "-o",
                      str(tmp_path / "b.cluster"), "-d", "0.05"],
                     device=CPU) == 0
    assert folder_digest(src) == before
    assert len([p for p in tmp_path.iterdir()
                if p.name.startswith("20")]) == 2


def _cli_exit(fn, argv, capsys, **kw):
    """(exit code, last line of stderr) of ``fn(argv)`` as the console
    entry ``cli()`` reports it: a FileNotFoundError or ValueError is
    ``ERROR: <message>`` and exit code 1."""
    capsys.readouterr()
    try:
        rc = fn(argv, **kw)
    except (FileNotFoundError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        rc = 1
    return rc, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("extra", [
    ["--append", "x.list", "--presketched", "dir"],
    ["--fast", "--save-rep", "--presketched", "dir"],
    ["--fast", "--buildDB", "db"],
    ["--fast", "--db", "rep.db"],
    ["--fast", "--sketch-func", "HLL"],
    ["--fast", "--multihost", "localhost:1,1,0"],
], ids=["append", "save-rep", "buildDB", "db", "sketch-func", "multihost"])
def test_cli_arms_outside_the_slice_exit_1(extra, tmp_path, capsys):
    """Arms given what they cannot run exit 1 with the JAX CLI's exit code
    and error: ``append`` (the MinHash --append) and ``save-rep`` over a
    missing folder, ``--buildDB`` without ``-l``, ``--db`` without a verb,
    ``--fast --sketch-func`` (fresh genome input only) and ``--multihost``
    without ``-i`` (the JAX CLI's ``run_multihost`` refusal).  Every arm
    is ported: none says "not ported"."""
    argv = ["--device", "-o", str(tmp_path / "o.cluster")] + extra
    want = _cli_exit(jax_main, argv, capsys)
    got = _cli_exit(port_main, argv, capsys, device=CPU)
    assert got == want and got[0] == 1
    assert "not ported" not in got[1]
    if "--sketch-func" in extra:
        assert "supports fresh genome input only" in got[1]
    elif "--multihost" in extra:
        assert "--multihost requires -i/--input genomes" in got[1]
    assert not (tmp_path / "o.cluster").exists()


@pytest.mark.parametrize("extra", [
    ["--fast", "--append", "x.list", "--presketched", "dir"],
    ["--append", "x.list", "--presketched", "dir"],
    ["--fast", "--save-rep", "--presketched", "dir"],
    ["--fast", "--db", "rep.db"],
    ["--fast", "--multihost", "localhost:1,1,0"],
], ids=["append", "minhash-append", "save-rep", "db", "multihost"])
def test_greedy_cli_arms_outside_the_slice_exit_1(extra, tmp_path, capsys):
    """As clust-mst's: the port's exit code and error are the JAX CLI's
    (the KSSD and MinHash --append and --save-rep over a missing folder,
    --db without a verb, --multihost without ``-i``)."""
    argv = ["--device", "-o", str(tmp_path / "o.cluster")] + extra
    want = _cli_exit(jax_greedy_main, argv, capsys)
    got = _cli_exit(port_greedy_main, argv, capsys, device=CPU)
    assert got == want and got[0] == 1
    assert "not ported" not in got[1]
    if "--multihost" in extra:
        assert "--multihost requires -i/--input genomes" in got[1]
    assert not (tmp_path / "o.cluster").exists()


MULTIHOST = ["--multihost", "localhost:1,1,0"]


@pytest.mark.parametrize("module,argv,message", [
    ("mst", ["-l", "-i", "x.list"], "--multihost requires --fast"),
    ("greedy", ["-l", "-i", "x.list"], "--multihost requires --fast"),
    ("leiden", ["-l", "-i", "x.list"], "--multihost requires --fast"),
    ("dbscan", ["-l", "-i", "x.list"], "--multihost requires --fast"),
    ("mst", ["--fast"], "--multihost requires -i/--input"),
    ("leiden", ["--fast"], "--multihost requires -i/--input"),
    ("mst", ["--fast", "-i", "x.list", "--presketched", "dir"],
     "--multihost supports fresh genome input only"),
    ("greedy", ["--fast", "-i", "x.list", "--presketched", "dir"],
     "--multihost supports fresh genome input only"),
    ("mst", ["--fast", "-i", "x.list", "--premsted", "dir"],
     "--multihost supports fresh genome input only"),
    ("dbscan", ["--minhash", "-l", "-i", "x.list"],
     "--multihost clust-dbscan requires --fast"),
], ids=["mst-no-fast", "greedy-no-fast", "leiden-no-fast", "dbscan-no-fast",
        "mst-no-input", "leiden-no-input", "mst-presketched",
        "greedy-presketched", "mst-premsted", "dbscan-minhash"])
def test_cli_multihost_refusals_match_jax(module, argv, message, tmp_path,
                                          capsys):
    """The port's ``--multihost`` refuses what the JAX CLIs refuse, with
    their exit code and message, before any process group is joined."""
    out = str(tmp_path / "o.cluster")
    jax_fn = jax_main if module == "mst" else MAINS[module][0]
    port_fn = port_main if module == "mst" else MAINS[module][1]
    args = argv + ["-o", out] + MULTIHOST
    assert jax_fn(args) == 1
    jax_err = capsys.readouterr().err
    assert port_fn(args, device=CPU) == 1
    port_err = capsys.readouterr().err
    assert message in jax_err and message in port_err
    assert port_err.strip().splitlines()[-1] == \
        jax_err.strip().splitlines()[-1]
    assert not os.path.exists(out)


@pytest.mark.parametrize("module", ["mst", "greedy"])
def test_cli_db_multihost_waits_for_repdb(module, tmp_path, capsys):
    """``--db ... --multihost`` takes the JAX CLIs' RepDB dispatch:
    clust-mst's MST RepDB verbs (which run in each process) fail on the
    missing RepDB file, clust-greedy's serving path refuses a verb other
    than --query/--assign, both before any process group is joined and as
    the JAX CLIs do (``tests/test_torch_multihost_workflow.py`` serves
    --query and --assign)."""
    out = str(tmp_path / "o.cluster")
    verb = "--query" if module == "mst" else "--stats"
    argv = ["--fast", "-l", "-i", "x.list", "--db",
            str(tmp_path / "rep.db"), verb, "-o", out] + MULTIHOST
    jax_fn = jax_main if module == "mst" else jax_greedy_main
    port_fn = port_main if module == "mst" else port_greedy_main
    want = _cli_exit(jax_fn, argv, capsys)
    got = _cli_exit(port_fn, argv, capsys, device=CPU)
    assert got == want and got[0] == 1
    assert ("No such file" in got[1]) == (module == "mst")
    assert not os.path.exists(out)


def test_cli_mst_state_append_exits_1(tmp_path, capsys):
    """An --append over a folder with a saved mst_cluster_state.bin takes
    the state machine: an empty state file is refused with the JAX CLI's
    error."""
    (tmp_path / "mst_cluster_state.bin").write_bytes(b"")
    argv = ["--fast", "--device", "--presketched", str(tmp_path),
            "--append", "x.list", "-o", str(tmp_path / "o.cluster")]
    want = _cli_exit(jax_main, argv, capsys)
    got = _cli_exit(port_main, argv, capsys, device=CPU)
    assert got == want == (1, f"ERROR: bad MST state magic in "
                              f"{tmp_path / 'mst_cluster_state.bin'}")


def test_cli_minhash_arm_and_missing_device_exit_1(tmp_path, capsys):
    """Both CLIs run the device engines only: without --device they exit
    1, clust-mst (KSSD and MinHash arms) and clust-greedy alike."""
    out = str(tmp_path / "o.cluster")
    for fn, argv in ((port_main, ["--fast", "-l", "-i", "x"]),
                     (port_main, ["-l", "-i", "x"]),
                     (port_greedy_main, ["--fast", "-l", "-i", "x"]),
                     (port_greedy_main, ["-l", "-i", "x"])):
        assert fn(argv + ["-o", out], device=CPU) == 1
        assert "pass --device" in capsys.readouterr().err


def test_cli_device_none_requires_cuda(synthetic_genomes, tmp_path,
                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(_fresh_args(synthetic_genomes) +
                  ["-e", "-o", str(tmp_path / "o.cluster")])


@pytest.mark.parametrize("verb", ["greedy-query", "mst-build"])
def test_repdb_device_programs_require_cuda(verb, synthetic_genomes,
                                            tmp_path, monkeypatch):
    """The RepDB verbs with a device program, the greedy KSSD --query and
    the MST --build, run it on the CLI's device with or without --device:
    ``device=None`` without a GPU raises, as on the clustering arms."""
    db = str(tmp_path / "rep.db")
    args = ["--fast", "-l", "-i", synthetic_genomes.list_file, "-d", "0.05",
            "--drlevel", "2", "-m", "1000", "--db", db, "-o",
            str(tmp_path / "o.txt")]
    if verb == "greedy-query":  # the build is host code
        assert port_greedy_main(args + ["--build"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if verb == "greedy-query":
            port_greedy_main(args + ["--query"])
        else:
            port_main(args + ["--build"])


@pytest.mark.parametrize("module", ["mst", "greedy"])
def test_cli_append_device_policy(module, tmp_path, monkeypatch, capsys):
    """Without --device, an --append that would re-cluster on the device
    engines (the MinHash classic append) exits 1 asking for it; a host
    append (the KSSD greedy append, here over an empty folder) runs as the
    JAX CLI's does and fails as it does, on the missing sketches."""
    fns = {"mst": (port_main, jax_main),
           "greedy": (port_greedy_main, jax_greedy_main)}[module]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--presketched", str(tmp_path), "--append", "x.list", "-l",
            "-o", str(tmp_path / "o.cluster")]
    assert fns[0](argv) == 1
    assert "pass --device" in capsys.readouterr().err
    if module == "greedy":
        want = _cli_exit(fns[1], ["--fast"] + argv, capsys)
        got = _cli_exit(fns[0], ["--fast"] + argv, capsys)
        assert got == want and got[0] == 1


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rabbittclust_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 10, mods\n"
        "bad = [m for m in sys.modules if m in ('jax', 'rabbittclust_tpu') "
        "or m.startswith(('jax.', 'jaxlib', 'rabbittclust_tpu.'))]\n"
        "assert not bad, bad[:5]\n"
        "print('ok', len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["RTC_PROFILE_DIR"] = ""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.fixture(scope="module")
def kssd_folder(synthetic_genomes, tmp_path_factory):
    """A --presketched KSSD run folder of the synthetic genomes (saved by
    the JAX clust-leiden, which writes sketches, index and leiden.graph)."""
    wd = tmp_path_factory.mktemp("kssd_folder")
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        assert jax_leiden_main(_fresh_args(synthetic_genomes) +
                               ["-o", str(wd / "out.cluster")]) == 0
    finally:
        os.chdir(cwd)
    runs = [p for p in wd.iterdir() if p.is_dir()]
    assert len(runs) == 1
    return runs[0]


DBSCAN_ARMS = {
    "presketched": ["--fast", "--device", "--eps", "0.05", "--minpts", "3"],
    "fasta": ["--fast", "--device", "--eps", "0.05", "--minpts", "3",
              "--drlevel", "2", "-m", "1000"],
    "knn": ["--fast", "--device", "--eps", "0.05", "--minpts", "3",
            "--knn", "2", "--drlevel", "2", "-m", "1000"],
    "max_posting": ["--fast", "--device", "--eps", "0.05", "--minpts", "3",
                    "--max-posting", "3", "--drlevel", "2", "-m", "1000"],
    "minhash": ["--device", "--minhash", "--eps", "0.05", "--minpts", "3",
                "-m", "1000", "-s", "300"],
}


@pytest.mark.parametrize("mode", ["mask", "idx"])
@pytest.mark.parametrize("arm", list(DBSCAN_ARMS))
def test_cli_dbscan_byte_equal(arm, mode, synthetic_genomes, kssd_folder,
                               tmp_path, monkeypatch):
    """clust-dbscan --device: the KSSD arms take the device filter (K1, and
    K3 under idx); --max-posting and --minhash run on the host on both
    sides, as the JAX CLI does under --device."""
    monkeypatch.setenv("RTC_PULL_MODE", mode)
    argv = list(DBSCAN_ARMS[arm])
    if arm != "presketched":
        argv += ["-l", "-i", synthetic_genomes.list_file]
    res = _run_both(tmp_path, monkeypatch, argv, module="dbscan",
                    presketched=kssd_folder if arm == "presketched" else None)
    assert _same_bytes(res["jax"][0] / "out.cluster",
                       res["port"][0] / "out.cluster")
    with open(res["port"][0] / "out.cluster") as f:
        text = f.read()
    assert "# Total clusters:" in text and text.count("the cluster") >= 4


LEIDEN_ARMS = {
    "default": ({}, []),
    "force_mask": ({"RTC_LEIDEN_DEVICE": "force", "RTC_PULL_MODE": "mask"},
                   []),
    "force_idx": ({"RTC_LEIDEN_DEVICE": "force", "RTC_PULL_MODE": "idx"},
                  []),
    "louvain_idx": ({"RTC_LEIDEN_DEVICE": "force", "RTC_PULL_MODE": "idx"},
                    ["--louvain"]),
}


@pytest.mark.parametrize("arm", list(LEIDEN_ARMS))
def test_cli_leiden_byte_equal(arm, synthetic_genomes, tmp_path,
                               monkeypatch):
    """clust-leiden --fast --device from genomes: the .cluster file and the
    saved run folder (sketches, index, leiden.graph) byte-equal; then
    --pregraph over the saved folder at another resolution."""
    env, extra = LEIDEN_ARMS[arm]
    for key in ("RTC_LEIDEN_DEVICE", "RTC_PULL_MODE"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    res = _run_both(tmp_path / "fresh", monkeypatch,
                    _fresh_args(synthetic_genomes) + extra, module="leiden")
    (jw, jf), (pw, pf) = res["jax"], res["port"]
    assert _same_bytes(jw / "out.cluster", pw / "out.cluster")
    _same_folders(jf, pf)
    assert "leiden.graph" in {p.name for p in pf.iterdir()}
    with open(pw / "out.cluster") as f:
        assert f.read().count("the cluster") == 4
    for side, fn in (("jax", jax_leiden_main), ("port", port_leiden_main)):
        wd, folder = res[side]
        assert fn(["--pregraph", str(folder), "--resolution", "0.5", "-o",
                   str(wd / "re.cluster")] + extra) == 0
        assert fn(["--pregraph", str(folder / "leiden.graph"), "-o",
                   str(wd / "bare.cluster")]) == 0
    for name in ("re.cluster", "bare.cluster"):
        assert _same_bytes(jw / name, pw / name), name


def test_cli_leiden_presketched_no_save_byte_equal(kssd_folder, tmp_path,
                                                   monkeypatch):
    """--presketched -e under the forced device route: nothing saved."""
    monkeypatch.setenv("RTC_LEIDEN_DEVICE", "force")
    monkeypatch.setenv("RTC_PULL_MODE", "idx")
    res = _run_both(tmp_path, monkeypatch, ["--fast", "--device", "-e"],
                    presketched=kssd_folder, module="leiden")
    (jw, _), (pw, _) = res["jax"], res["port"]
    assert _same_bytes(jw / "out.cluster", pw / "out.cluster")
    # the copied folder's graph is the one it came with
    assert _same_bytes(kssd_folder / "leiden.graph",
                       pw / "sketches" / "leiden.graph")


@pytest.mark.parametrize("main_fn", [port_dbscan_main, port_leiden_main],
                         ids=["dbscan", "leiden"])
def test_cli_dbscan_leiden_refusals(main_fn, tmp_path, capsys):
    """--multihost (ported) without -i exits 1 with the JAX CLI's refusal;
    without --device the port's clust-dbscan and clust-leiden exit 1."""
    out = str(tmp_path / "o.cluster")
    assert main_fn(["--fast", "--device", "--multihost", "localhost:1,1,0",
                    "-o", out], device=CPU) == 1
    err = capsys.readouterr().err
    assert "--multihost requires -i/--input genomes" in err
    assert "not ported" not in err
    assert main_fn(["--fast", "-l", "-i", "x", "-o", out], device=CPU) == 1
    assert "pass --device" in capsys.readouterr().err
    assert not (tmp_path / "o.cluster").exists()
