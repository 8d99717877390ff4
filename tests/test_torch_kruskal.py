"""The port's compiled Kruskal (``cluster/mst.py::kruskal`` over
``hostsrc/kruskal.cpp``) against the JAX package's Python Kruskal: the
kept (i, j, d) byte-equal, dtypes equal; and the g++ build of the port's
host library (``kernels/_build.py::build_host``)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from rabbittclust_tpu.cluster import mst as jax_mst
from rabbittclust_tpu_torch.cluster import mst as port_mst
from rabbittclust_tpu_torch.kernels import _build
from rabbittclust_tpu_torch.utils import profiling


def _random_edges(rng, n, m, ids=None, levels=7):
    """m edges i < j over ``ids`` (default 0..n-1), d drawn from ``levels``
    values, so exact ties are many; repeated (i, j) pairs included."""
    ids = np.arange(n) if ids is None else ids
    a = ids[rng.integers(0, len(ids), m)]
    b = ids[rng.integers(0, len(ids), m)]
    ok = a != b
    i, j = np.minimum(a, b)[ok], np.maximum(a, b)[ok]
    d = rng.integers(0, levels, len(i)) * 0.0125
    return i.astype(np.int64), j.astype(np.int64), d


def _ties(seed):
    rng = np.random.default_rng(seed)
    return _random_edges(rng, 300, 6000), 300


def _signed_zero():
    rng = np.random.default_rng(5)
    i, j, d = _random_edges(rng, 120, 900, levels=3)
    d = d.copy()
    d[d == 0.0] = np.where(rng.random(int((d == 0.0).sum())) < 0.5,
                           -0.0, 0.0)
    # the same (i, j) at -0.0 and 0.0, in both input orders
    i = np.concatenate([i, [3, 3, 7, 7]])
    j = np.concatenate([j, [9, 9, 11, 11]])
    d = np.concatenate([d, [-0.0, 0.0, 0.0, -0.0]])
    return (i, j, d), 120


def _nan_last():
    rng = np.random.default_rng(6)
    i, j, d = _random_edges(rng, 200, 1500)
    d = d.copy()
    nan = rng.random(len(d)) < 0.2
    # NaNs of both signs and several payloads: lexsort takes them all as
    # equal, last
    bits = (np.uint64(0x7FF8000000000000)
            | rng.integers(0, 1 << 20, int(nan.sum())).astype(np.uint64)
            | (rng.integers(0, 2, int(nan.sum())).astype(np.uint64)
               << np.uint64(63)))
    d[nan] = bits.view(np.float64)
    d[:3] = [np.inf, -np.inf, -1.5]
    return (i, j, d), 200


def _spanning():
    """Dense enough to span long before the last edge: the early stop."""
    rng = np.random.default_rng(7)
    return _random_edges(rng, 64, 5000), 64


def _not_spanning():
    """Edges within four groups and ids past the last edge's: every edge
    is walked."""
    rng = np.random.default_rng(8)
    parts = [_random_edges(rng, 0, 800, ids=np.arange(g * 50, g * 50 + 40))
             for g in range(4)]
    return port_mst.concat_edges(parts), 230


def _wide_ids():
    """Ids above 2**16, paired with ids equal to them in their low 16 bits:
    a narrowed id type would merge them."""
    rng = np.random.default_rng(9)
    base = rng.choice(1 << 16, 150, replace=False)
    ids = np.concatenate([base, base + (1 << 16), base + (3 << 16)])
    return _random_edges(rng, 0, 4000, ids=ids), (3 << 16) + (1 << 16)


def _int32_ids():
    (i, j, d), n = _ties(11)
    return (i.astype(np.int32), j.astype(np.int32), d), n


def _self_loops_n1():
    return (np.zeros(4, np.int64), np.zeros(4, np.int64),
            np.array([0.5, 0.0, -0.0, 0.1])), 1


def _empty():
    return port_mst._empty_edges(), 10


CASES = {
    "ties_0": lambda: _ties(0),
    "ties_1": lambda: _ties(1),
    "ties_2": lambda: _ties(2),
    "signed_zero": _signed_zero,
    "nan_last": _nan_last,
    "spanning": _spanning,
    "not_spanning": _not_spanning,
    "wide_ids": _wide_ids,
    "int32_ids": _int32_ids,
    "n_1": _self_loops_n1,
    "empty": _empty,
}


def _assert_same(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_kruskal_byte_equal_to_jax(case):
    e, n = CASES[case]()
    _assert_same(port_mst.kruskal(e, n), jax_mst.kruskal(e, n))


@pytest.mark.parametrize("case", ["ties_0", "signed_zero", "not_spanning",
                                  "wide_ids", "empty"])
def test_kruskal_presorted_byte_equal_to_jax(case):
    """``presorted=True`` walks the given order: on sorted edges and on
    edges left unsorted."""
    e, n = CASES[case]()
    for edges in (jax_mst.sort_edges(e), e):
        _assert_same(port_mst.kruskal(edges, n, presorted=True),
                     jax_mst.kruskal(edges, n, presorted=True))


def test_kruskal_keeps_the_lexsort_order():
    """The kept edges come in ``sort_edges``'s order, and the forest of the
    sorted edges is the forest of the unsorted ones."""
    (i, j, d), n = _not_spanning()
    ki, kj, kd = port_mst.kruskal((i, j, d), n)
    order = np.lexsort((kj, ki, kd))
    assert np.array_equal(order, np.arange(len(ki)))
    _assert_same(port_mst.kruskal(port_mst.sort_edges((i, j, d)), n),
                 (ki, kj, kd))


@pytest.mark.parametrize("i, j, n", [([0, 5], [1, 2], 5),
                                     ([0, -1], [1, 2], 5),
                                     ([0], [1], 1 << 32)])
def test_kruskal_rejects_ids_outside_n(i, j, n):
    e = (np.array(i, np.int64), np.array(j, np.int64),
         np.full(len(i), 0.01))
    with pytest.raises(ValueError, match="every edge id"):
        port_mst.kruskal(e, n)


def test_kruskal_counts_the_edges_given():
    (e1, n), (e2, _) = _ties(3), _ties(4)
    stats = {}
    with profiling.job(stats):
        port_mst.kruskal(e1, n)
        port_mst.kruskal(e2, n, presorted=True)
        port_mst.kruskal(port_mst._empty_edges(), n)
    assert stats["counters"]["mst.kruskal_edges"] == len(e1[0]) + len(e2[0])


def test_host_library_rebuilt_under_a_new_key_without_nvcc(tmp_path,
                                                           monkeypatch):
    """A changed source builds a second library under a new key; an
    unchanged one is not built again; g++ alone is run."""
    src = tmp_path / "hostsrc"
    shutil.copytree(_build.HOSTSRC_DIR, src)
    monkeypatch.setattr(_build, "HOSTSRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))

    def no_nvcc():
        raise AssertionError("the host build looked for nvcc")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    commands = []
    run = subprocess.run

    def recording_run(cmd, *args, **kw):
        commands.append(list(cmd))
        return run(cmd, *args, **kw)

    monkeypatch.setattr(_build.subprocess, "run", recording_run)

    first = _build.build_host()
    assert first["seconds"] > 0 and os.path.exists(first["path"])
    again = _build.build_host()
    assert again["path"] == first["path"] and again["seconds"] == 0.0
    with open(src / "kruskal.cpp", "a") as f:
        f.write("\n// changed\n")
    second = _build.build_host()
    assert second["path"] != first["path"] and second["seconds"] > 0
    assert os.path.exists(first["path"]) and os.path.exists(second["path"])
    assert [c[0] for c in commands] == ["g++", "g++"]

    lib = ctypes.CDLL(second["path"])
    lib.rtc_kruskal.restype = ctypes.c_int64
    lib.rtc_kruskal.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
        + [ctypes.c_int, ctypes.c_void_p]
    i = np.array([0, 1, 0], np.int64)
    j = np.array([1, 2, 2], np.int64)
    d = np.array([0.2, 0.1, 0.3])
    kept = np.empty(2, np.int64)
    assert lib.rtc_kruskal(i.ctypes.data, j.ctypes.data, d.ctypes.data, 3,
                           3, 0, kept.ctypes.data) == 2
    assert kept.tolist() == [1, 0]
