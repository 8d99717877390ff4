"""The port stands alone: no module of ``rabbittclust_tpu_torch`` and not
``chip_smoke.py`` imports the JAX package ``rabbittclust_tpu`` (not even a
module of it that does not import JAX) or ``jax``; the port keeps its own
copies of the host code it needs.

(a) reads every source with ``ast``; (b) runs each of the port's clust-mst,
clust-greedy, clust-dbscan and clust-leiden arms (the device sketcher's
``RTC_DEVICE_SKETCH=1``, ``--sketch-func WMH|OMH|HLL``, the mesh rings
under ``RTC_MESH=1``, the RepDB verbs, ``--buildDB`` and the state-file
``--save-rep`` / ``--append`` arms among them) on
the CPU in a fresh process and lists what that process loaded;
(c) the port copies none of the JAX package's NumPy fallbacks: its loader
of the shared native library raises when the library cannot be had.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("rabbittclust_tpu", "jax", "jaxlib")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    files = sorted(glob.glob(os.path.join(REPO, "rabbittclust_tpu_torch",
                                          "**", "*.py"), recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py")]


def _imports(path):
    """(line, module) of every absolute import in ``path``, also those
    inside functions and strings that are compiled code (``ast`` sees only
    real import statements, so names in strings and comments are not
    imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_source_imports_the_jax_package():
    files = _sources()
    assert len(files) > 30, files
    bad = [f"{os.path.relpath(path, REPO)}:{line}: {mod}"
           for path in files for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


def test_the_static_check_sees_imports(tmp_path):
    """The check above finds an import of the JAX package at any depth and
    passes the port's own and relative imports."""
    src = tmp_path / "m.py"
    src.write_text(
        "import rabbittclust_tpu_torch.ops\n"
        "from . import workflows\n"
        "S = 'rabbittclust_tpu/ops/bitmap.py:345'\n"
        "def f():\n"
        "    from rabbittclust_tpu.state import sketch_io\n"
        "    import jax.numpy\n")
    assert [m for _, m in _imports(src) if _forbidden(m)] == [
        "rabbittclust_tpu.state", "jax.numpy"]


# Each arm: a list of (CLI, argv[, environment]) runs in one process (the
# prep run of the saved arms saves the run folder they read); "{list}" is the genome list
# file, "{half}" a list of its first half, "{rest}" of the rest, "{run}"
# the run folder the first run saved.
_FRESH = ["--fast", "--device", "-l", "-i", "{list}", "-d", "0.05",
          "--drlevel", "2", "-m", "1000"]
_MINHASH = ["--device", "-l", "-i", "{list}", "-d", "0.05", "-m", "1000"]
_HALF = ["-l", "-i", "{half}", "-d", "0.05", "-m", "1000"]
_APPEND = ["--device", "--presketched", "{run}", "--append", "{rest}", "-l",
           "-d", "0.05", "-m", "1000"]
_DB = ["--fast", "--drlevel", "2", "-m", "1000", "--db", "rep.db"]
_MHDB = ["-m", "1000", "-s", "300", "--db", "mh.db"]
ARMS = {
    "default_save": [("mst", _FRESH)],
    "e": [("mst", _FRESH + ["-e", "-t", "2"])],
    "newick_tree": [("mst", _FRESH + ["-e", "--newick-tree", "--nexus-tree",
                                      "--phylip-tree", "--linkage-matrix"])],
    "auto_threshold": [("mst", _FRESH + ["-e", "--auto-threshold",
                                         "--stability"])],
    "presketched": [("mst", _FRESH),
                    ("mst", ["--fast", "--device", "--presketched", "{run}",
                             "-d", "0.05"])],
    "premsted": [("mst", _FRESH),
                 ("mst", ["--fast", "--premsted", "{run}", "-d", "0.03",
                          "--dedup-dist", "0.01", "--reps-per-cluster",
                          "2"])],
    "greedy_kssd": [("greedy", _FRESH),
                    ("greedy", ["--fast", "--device", "--presketched",
                                "{run}", "-d", "0.05"])],
    "greedy_minhash": [("greedy", _MINHASH),
                       ("greedy", ["--device", "--presketched", "{run}",
                                   "-d", "0.05"])],
    "minhash_mst": [("mst", _MINHASH + ["-s", "300"]),
                    ("mst", ["--device", "--presketched", "{run}", "-d",
                             "0.05"]),
                    ("mst", ["--premsted", "{run}", "-d", "0.03"])],
    "append": [("mst", ["--fast", "--device", "-l", "-i", "{half}", "-d",
                        "0.05", "-m", "1000"]),
               ("mst", ["--fast", "--device", "--presketched", "{run}",
                        "--append", "{rest}", "-l", "-d", "0.05", "-m",
                        "1000"])],
    "dbscan": [("leiden", _FRESH),
               ("dbscan", ["--fast", "--device", "--presketched", "{run}",
                           "--minpts", "3"], {"RTC_PULL_MODE": "idx"}),
               ("dbscan", _FRESH + ["--max-posting", "3"]),
               ("dbscan", ["--device", "--minhash", "-l", "-i", "{list}",
                           "-m", "1000", "-s", "300"])],
    "mesh": [("mst", _FRESH, {"RTC_MESH": "1"}),
             ("mst", _FRESH + ["-e"], {"RTC_MESH": "1",
                                       "RTC_MST_CLUSTERS_FAST": "0"})],
    "device_sketch": [("mst", _FRESH, {"RTC_DEVICE_SKETCH": "1"}),
                      ("greedy", _FRESH, {"RTC_DEVICE_SKETCH": "1"})],
    "sketch_func": [("mst", ["--sketch-func", func, "-l", "-i", "{list}",
                             "-d", "0.5", "-m", "1000"])
                    for func in ("WMH", "OMH", "HLL")],
    "leiden": [("leiden", _FRESH, {"RTC_LEIDEN_DEVICE": "force",
                                   "RTC_PULL_MODE": "idx"}),
               ("leiden", ["--pregraph", "{run}"]),
               ("leiden", _FRESH + ["--louvain", "-e"])],
    "repdb_greedy": [
        ("mst", ["--fast", "--buildDB", "db", "-l", "-i", "{half}", "-m",
                 "1000", "--drlevel", "2"]),
        ("greedy", _DB + ["--build", "--presketched", "{run}"]),
        ("greedy", _DB + ["--query", "--device", "-l", "-i", "{rest}"]),
        ("greedy", _DB + ["--query", "-l", "-i", "{rest}"]),
        ("greedy", _DB + ["--assign", "-l", "-i", "{rest}"]),
        ("greedy", _DB + ["--stats"]),
        ("greedy", _DB + ["--append", "{rest}", "-l"])],
    "repdb_mst": [
        ("mst", _DB + ["--build", "--device", "-l", "-i", "{half}"]),
        ("mst", _DB + ["--query", "-l", "-i", "{rest}"]),
        ("mst", _DB + ["--stats"]),
        ("mst", _DB + ["--append", "{rest}", "-l"]),
        ("mst", _MHDB + ["--build", "--device", "-l", "-i", "{half}"]),
        ("mst", _MHDB + ["--assign", "-l", "-i", "{rest}"])],
    "repdb_minhash": [
        ("greedy", _MHDB + ["--build", "-l", "-i", "{half}"]),
        ("greedy", _MHDB + ["--query", "-l", "-i", "{rest}"]),
        ("greedy", _MHDB + ["--stats"]),
        ("greedy", _MHDB + ["--append", "{rest}", "-l"])],
    "state_append_mst": [("mst", ["--fast", "--device", "--save-rep"] + _HALF),
                         ("mst", ["--fast"] + _APPEND)],
    "state_append_greedy": [
        ("greedy", ["--fast", "--device", "--save-rep"] + _HALF),
        ("greedy", ["--fast", "--save-rep"] + _APPEND)],
    "minhash_append": [("mst", ["--device", "-s", "300"] + _HALF),
                       ("mst", _APPEND)],
    "minhash_greedy_append": [("greedy", ["--device", "--save-rep"] + _HALF),
                              ("greedy", _APPEND)],
}

_RUNNER = r"""
import os, sys, time
import torch
from rabbittclust_tpu_torch.cli import (clust_dbscan, clust_greedy,
                                        clust_leiden, clust_mst)
runs, list_file = eval(sys.argv[1]), sys.argv[2]
with open(list_file) as f:
    files = f.read().split()
for name, part in (("half", files[:len(files) // 2]),
                   ("rest", files[len(files) // 2:])):
    with open(f"{name}.list", "w") as f:
        f.write("\n".join(part) + "\n")
subs = {"{list}": list_file, "{half}": os.path.abspath("half.list"),
        "{rest}": os.path.abspath("rest.list")}
mains = {"mst": clust_mst.main, "greedy": clust_greedy.main,
         "dbscan": clust_dbscan.main, "leiden": clust_leiden.main}
run_dir = None
for k, (cli, argv, *env) in enumerate(runs):
    argv = [subs.get(a, run_dir if a == "{run}" else a) for a in argv]
    for key in ("RTC_PULL_MODE", "RTC_LEIDEN_DEVICE", "RTC_DEVICE_SKETCH"):
        os.environ.pop(key, None)
    os.environ.update(*env)
    if "--append" in argv:
        time.sleep(1.1)  # the append's own run folder gets a new timestamp
    rc = mains[cli](argv + ["-o", f"out{k}.cluster"],
                    device=torch.device("cpu"))
    assert rc == 0, (argv, rc)
    if "--stats" not in argv and "--buildDB" not in argv:
        assert os.path.getsize(f"out{k}.cluster") > 0
    if run_dir is None:
        dirs = [d for d in os.listdir(".") if os.path.isdir(d)]
        run_dir = os.path.abspath(dirs[0]) if len(dirs) == 1 else None
bad = [m for m in sys.modules if m in ("rabbittclust_tpu", "jax", "jaxlib")
       or m.startswith(("rabbittclust_tpu.", "jax.", "jaxlib."))]
print("loaded:", bad)
assert not bad, bad
"""


@pytest.mark.parametrize("arm", list(ARMS))
def test_cli_arm_loads_no_jax_package(arm, synthetic_genomes, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "RTC_MST_CLUSTERS_FAST")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, repr(ARMS[arm]),
         synthetic_genomes.list_file],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout
    if arm in ("newick_tree", "auto_threshold", "premsted"):
        names = {"newick_tree": "out0.cluster.newick.tree",
                 "auto_threshold": "out0.cluster.threshold_analysis.txt",
                 "premsted": "out1.cluster.reps"}
        assert (tmp_path / names[arm]).exists(), sorted(os.listdir(tmp_path))


def test_native_library_is_required(monkeypatch, tmp_path):
    from rabbittclust_tpu_torch.utils import native
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "_SRC_PATH", str(tmp_path / "missing.cpp"))
    native.load_native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="missing.so"):
            native.load_native()
    finally:
        native.load_native.cache_clear()


# The multi-process arms: every rank is a process of its own, and each
# checks what it loaded.  ``{coord}`` is the ranks' coordinator address,
# ``{pid}`` the rank.
_RANK_RUNNER = r"""
import sys
import torch
arm, coord, pid, list_file = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    sys.argv[4]
if arm in ("mst", "greedy"):
    from rabbittclust_tpu_torch.cli import clust_greedy, clust_mst
    main = clust_mst.main if arm == "mst" else clust_greedy.main
    assert main(["--fast", "-l", "-i", list_file, "-m", "1000", "-d",
                 "0.05", "-o", "out.cluster", "--multihost",
                 f"{coord},2,{pid}"]) == 0
elif arm == "repdb":
    from rabbittclust_tpu_torch.cli import clust_greedy
    assert clust_greedy.main(["--fast", "--db", "rep.db", "--assign", "-l",
                              "-i", list_file, "-m", "1000", "-o", "a.tsv",
                              "--multihost", f"{coord},2,{pid}"]) == 0
elif arm == "sim":
    from rabbittclust_tpu_torch.parallel.multihost import _sim_child
    _sim_child(pid, 2, int(coord.split(":")[1]), 2, 20)
else:
    from rabbittclust_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(2, devices=[torch.device("cpu")] * 2)
bad = [m for m in sys.modules if m in ("rabbittclust_tpu", "jax", "jaxlib")
       or m.startswith(("rabbittclust_tpu.", "jax.", "jaxlib."))]
print("loaded:", bad)
assert not bad, bad
"""


@pytest.mark.parametrize("arm", ["mst", "greedy", "repdb", "sim",
                                 "dryrun"])
def test_multihost_ranks_load_no_jax_package(arm, synthetic_genomes,
                                             tmp_path):
    """Each rank of a ``--multihost`` CLI run (``repdb``: the RepDB probe,
    ``--db --assign``) and of the simulation, and the dry run (whose own
    simulation's children run ``_sim_child``), load nothing of JAX or the
    JAX package."""
    from rabbittclust_tpu_torch.parallel.multihost import free_port, run_ranks
    if arm == "repdb":
        from rabbittclust_tpu_torch.cli.clust_greedy import main
        assert main(["--fast", "--db", str(tmp_path / "rep.db"), "--build",
                     "-l", "-i", synthetic_genomes.list_file, "-m", "1000",
                     "-o", str(tmp_path / "db.cluster")]) == 0
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, RTC_VIRTUAL_CPU_DEVICES="2")
    coord = f"127.0.0.1:{free_port()}"
    ranks = 1 if arm == "dryrun" else 2
    rcs, outs, errs = run_ranks(
        [[sys.executable, "-c", _RANK_RUNNER, arm, coord, str(pid),
          synthetic_genomes.list_file] for pid in range(ranks)],
        env=env, timeout=300, cwd=str(tmp_path))
    for rc, out, err in zip(rcs, outs, errs):
        assert rc == 0, err[-3000:]
        assert "loaded: []" in out
