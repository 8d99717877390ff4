"""Kernels K4 / K5b and the slice's engine on the card, against their plain
torch versions and the native host engine.  Marked ``cuda``; every test
skips inside itself when no GPU is visible.  This file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rabbittclust_tpu_torch.host import (
    clusters_from_forest,
    compute_mst,
    cut_forest,
    pack_sketches,
)
from rabbittclust_tpu_torch.ops import engine
from rabbittclust_tpu_torch.ops import intersect as ix
from rabbittclust_tpu_torch.ops.pack import planes_to_device
from torch_port_data import clustered_sketches

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _planes(n, s, use64, device, bucket_bits=None, pad_n_to=128, seed=3):
    dtype = np.uint64 if use64 else np.uint32
    hashes = clustered_sketches(n=n, s=s, n_clusters=max(n // 40, 1),
                                seed=seed, dtype=dtype, keep=0.8)
    pk = pack_sketches(hashes, use64, bucket_bits=bucket_bits,
                       pad_n_to=pad_n_to)
    return hashes, pk, planes_to_device(pk, device)


@pytest.mark.parametrize("use64", [False, True], ids=["1plane", "2plane"])
@pytest.mark.parametrize("bucket_bits", [None, 3], ids=["W_natural", "W_wide"])
def test_k4_matches_plain_small_ragged(gpu, use64, bucket_bits):
    _, pk, pl = _planes(300, 150, use64, gpu, bucket_bits=bucket_bits)
    rb = 128
    r0s, c0s, val = [0, 128, 256, 256, 0], [0, 0, 128, 256, 0], [1] * 4 + [0]
    before = ix.LAUNCHES["pair_counts_tiles"]
    got = ix.pair_counts_tiles(pl.plane0, pl.plane1, r0s, c0s, val, rb)
    torch.cuda.synchronize()
    assert ix.LAUNCHES["pair_counts_tiles"] == before + 1
    for t in range(4):
        a, b = slice(r0s[t], r0s[t] + rb), slice(c0s[t], c0s[t] + rb)
        want = ix.pair_counts_plain(
            pl.plane0[a], pl.plane0[b],
            None if pl.plane1 is None else pl.plane1[a],
            None if pl.plane1 is None else pl.plane1[b])
        assert torch.equal(got[t], want), (t, pk.width)


@pytest.mark.parametrize("use64", [False, True], ids=["1plane", "2plane"])
def test_k4_matches_plain_slice_shape(gpu, use64):
    """W = 12, K = 1024, rb = 4096: one tile, compared in 512-row slices."""
    _, pk, pl = _planes(8192, 1000, use64, gpu, pad_n_to=4096, seed=7)
    assert pk.k == 1024
    rb = 4096
    got = ix.pair_counts_tiles(pl.plane0, pl.plane1, [4096], [0], [1], rb)[0]
    for s in range(0, rb, 512):
        a, b = slice(4096 + s, 4096 + s + 512), slice(0, rb)
        want = ix.pair_counts_plain(
            pl.plane0[a], pl.plane0[b],
            None if pl.plane1 is None else pl.plane1[a],
            None if pl.plane1 is None else pl.plane1[b])
        assert torch.equal(got[s:s + 512], want), s


@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
def test_k5b_matches_plain(gpu, use64):
    _, pk, pl = _planes(2048, 1000, use64, gpu)
    rng = np.random.default_rng(1)
    ii = rng.integers(0, 2048, size=100_000)
    jj = rng.integers(0, 2048, size=100_000)
    got = ix.pair_common(pl.plane0, pl.plane1, ii, jj)
    want = ix.pair_common_plain(pl.plane0, pl.plane1,
                                torch.from_numpy(ii).to(gpu),
                                torch.from_numpy(jj).to(gpu))
    assert torch.equal(got, want)
    assert int(want.max()) > 0


def test_wrapper_rejects_bad_planes(gpu):
    bad = torch.zeros((64, 6, 64), dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="W % 4"):
        ix.pair_counts_tiles(bad, None, [0], [0], [1], 32)
    with pytest.raises(ValueError, match="int32"):
        ix.pair_common(bad.float(), None, [0], [1])


def test_engine_on_card_matches_host(gpu):
    hashes = clustered_sketches(n=3000, s=400, n_clusters=30, seed=5)
    ix.reset_launches()
    stats = {}
    got = engine.compute_mst_device(hashes, 0.05, 21, device=gpu,
                                    with_dense=True, stats=stats)
    assert ix.LAUNCHES["pair_counts_tiles"] > 0
    assert ix.LAUNCHES["pair_common"] > 0
    want = compute_mst(hashes, 0.05, 21, with_dense=True)
    n = len(hashes)
    assert len(got.mst[0]) == len(want.mst[0])
    np.testing.assert_allclose(np.sort(got.mst[2]), np.sort(want.mst[2]),
                               rtol=1e-12, atol=0)
    part = [sorted(c) for c in clusters_from_forest(cut_forest(got.mst,
                                                               0.05), n)]
    ref = [sorted(c) for c in clusters_from_forest(cut_forest(want.mst,
                                                              0.05), n)]
    assert sorted(part) == sorted(ref)
    assert np.array_equal(got.ani, want.ani)
    assert stats["sweep_ms"] > 0
