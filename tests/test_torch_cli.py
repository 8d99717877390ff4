"""The port's clust-mst CLI on the CPU (``main(argv, device=cpu)``) against
the JAX package's CLI: cluster files, trees and edge.mst byte-equal.

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

from rabbittclust_tpu.cli.clust_mst import main as jax_main
from rabbittclust_tpu_torch.cli.clust_mst import main as port_main

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_both(tmp_path, monkeypatch, argv, presketched=None,
              mst_free=False):
    """Run argv through both CLIs, each in its own working directory (run
    folders are named by the clock); returns {side: (out_dir, folder)}."""
    monkeypatch.setenv("RTC_MESH", "0")
    if mst_free:
        monkeypatch.delenv("RTC_MST_CLUSTERS_FAST", raising=False)
        monkeypatch.setenv("RTC_PULL_MODE", "mask")
    else:
        monkeypatch.setenv("RTC_MST_CLUSTERS_FAST", "0")
    res = {}
    for side, fn in (("jax", jax_main), ("port", port_main)):
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


@pytest.mark.parametrize("extra", [
    ["--append", "x.list", "--presketched", "dir"],
    ["--save-rep"],
    ["--buildDB", "db"],
    ["--db", "rep.db"],
    ["--sketch-func", "HLL"],
    ["--multihost", "localhost:1,1,0"],
], ids=["append", "save-rep", "buildDB", "db", "sketch-func", "multihost"])
def test_cli_arms_outside_the_slice_exit_1(extra, tmp_path, capsys):
    argv = ["--fast", "--device", "-o", str(tmp_path / "o.cluster")] + extra
    assert port_main(argv, device=CPU) == 1
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP Queue 1 item" in err
    assert not (tmp_path / "o.cluster").exists()


def test_cli_minhash_arm_and_missing_device_exit_1(tmp_path, capsys):
    out = str(tmp_path / "o.cluster")
    assert port_main(["--device", "-l", "-i", "x", "-o", out],
                     device=CPU) == 1
    assert "MinHash arm" in capsys.readouterr().err
    assert port_main(["--fast", "-l", "-i", "x", "-o", out],
                     device=CPU) == 1
    assert "pass --device" in capsys.readouterr().err


def test_cli_device_none_requires_cuda(synthetic_genomes, tmp_path,
                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(_fresh_args(synthetic_genomes) +
                  ["-e", "-o", str(tmp_path / "o.cluster")])


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
