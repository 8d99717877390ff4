"""The port's dense exact-MST engine on the CPU (plain kernel versions)
against the JAX engine (compact pull, jnp backend): MST arrays, dense and
ANI histograms byte-equal."""

import numpy as np
import pytest
import torch

from rabbittclust_tpu.cluster.mst import DENSE_SPAN, compute_mst
from rabbittclust_tpu.ops import engine as jax_engine
from rabbittclust_tpu_torch.ops import engine as port_engine
from torch_port_data import clustered_sketches, containment_sketches

CPU = torch.device("cpu")


def _assert_same(got, want):
    for g, w in zip(got.mst, want.mst):
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()
    assert got.n == want.n
    for name in ("dense", "ani"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


CASES = {
    "32bit_dense": dict(hashes=lambda: clustered_sketches(),
                        kw=dict(with_dense=True)),
    "64bit": dict(hashes=lambda: clustered_sketches(n=150,
                                                    dtype=np.uint64),
                  kw={}),
    "containment": dict(hashes=containment_sketches,
                        kw=dict(is_containment=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_byte_equal_to_jax(case):
    hashes = CASES[case]["hashes"]()
    kw = CASES[case]["kw"]
    want = jax_engine.compute_mst_device(hashes, 0.05, 21, backend="jnp",
                                         pull="compact", **kw)
    got = port_engine.compute_mst_device(hashes, 0.05, 21, device=CPU, **kw)
    _assert_same(got, want)
    assert len(got.mst[0]) > 0


def test_engine_append_byte_equal_to_jax():
    hashes = clustered_sketches(n=180)
    pre_n = 120
    pre = compute_mst(hashes[:pre_n], 0.05, 21)
    want = jax_engine.compute_mst_device(hashes, 0.05, 21, backend="jnp",
                                         pull="compact", start_index=pre_n,
                                         pre_edges=pre.mst)
    got = port_engine.compute_mst_device(hashes, 0.05, 21, device=CPU,
                                         start_index=pre_n,
                                         pre_edges=pre.mst)
    _assert_same(got, want)


def test_engine_multi_tile_multi_batch_budget_flush():
    """n=300 at row_block=128, batch_k=2: 6 tiles in 3 batches, a padded
    tail, and enough candidates to reach the Kruskal budget flush."""
    hashes = clustered_sketches(n=300, s=120, n_clusters=8, seed=21)
    want = jax_engine._compute_mst_device_compact(
        hashes, 0.05, 21, is_containment=False, with_dense=True,
        start_index=0, pre_edges=None, backend="jnp", row_block=128,
        batch_k=2)
    stats = {}
    got = port_engine.compute_mst_device(hashes, 0.05, 21, device=CPU,
                                         with_dense=True, row_block=128,
                                         batch_k=2, stats=stats)
    _assert_same(got, want)
    assert stats["tiles"] == 6 and stats["batches"] == 3
    assert stats["candidates"] > 4 * len(hashes)  # budget flush reached


def test_edges_from_pairs_copy_equals_jax():
    rng = np.random.default_rng(9)
    n = 50
    sizes = rng.integers(80, 200, size=n).astype(np.int64)
    ii = rng.integers(1, n, size=400)
    jj = rng.integers(0, n, size=400) % ii
    common = np.minimum(rng.integers(1, 120, size=400),
                        np.minimum(sizes[ii], sizes[jj]))
    radii = np.arange(DENSE_SPAN) / DENSE_SPAN
    for is_containment in (False, True):
        outs = []
        for fn in (jax_engine._edges_from_pairs,
                   port_engine._edges_from_pairs):
            dense = np.zeros((DENSE_SPAN, n), np.int64)
            ani = np.zeros(101, np.int64)
            d = fn(ii, jj, common, sizes, 0.05, 21, is_containment, True,
                   dense, ani, radii)
            outs.append((d, dense, ani))
        for a, b in zip(*outs):
            assert a.tobytes() == b.tobytes()


def test_engine_small_inputs():
    one = port_engine.compute_mst_device(clustered_sketches(n=1), 0.05, 21,
                                         device=CPU, with_dense=True)
    assert len(one.mst[0]) == 0 and one.dense.shape == (DENSE_SPAN, 1)
    two = clustered_sketches(n=2, n_clusters=1)
    want = jax_engine.compute_mst_device(two, 0.05, 21, backend="jnp",
                                         pull="compact")
    _assert_same(port_engine.compute_mst_device(two, 0.05, 21, device=CPU),
                 want)
