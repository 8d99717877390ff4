"""The port's pair-count layer (plain torch versions of kernels K4 / K5b,
the mask epilogue, bit-packing, device selection) against the JAX package
on the CPU.  Every comparison is exact: integers and bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbittclust_tpu.distance.mash import size_ratio_limit
from rabbittclust_tpu.ops import bitmap as jax_bitmap
from rabbittclust_tpu.ops import engine as jax_engine
from rabbittclust_tpu.ops.intersect import pair_counts_jnp, pair_counts_row
from rabbittclust_tpu.ops.pack import pack_sketches
from rabbittclust_tpu_torch.device import resolve_device
from rabbittclust_tpu_torch.ops import bitmap as port_bitmap
from rabbittclust_tpu_torch.ops import engine as port_engine
from rabbittclust_tpu_torch.ops import intersect as port
from rabbittclust_tpu_torch.ops.pack import planes_to_device
from torch_port_data import clustered_sketches

CPU = torch.device("cpu")


def _packed(use64, n=40, s=120, pad_n_to=8, seed=3):
    dtype = np.uint64 if use64 else np.uint32
    hashes = clustered_sketches(n=n, s=s, n_clusters=5, seed=seed,
                                dtype=dtype)
    return hashes, pack_sketches(hashes, use64, pad_n_to=pad_n_to)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("use64", [False, True], ids=["1plane", "2plane"])
def test_plain_counts_match_jnp(use64):
    _, pk = _packed(use64)
    a, b = slice(0, 16), slice(8, 40)
    p1 = pk.plane1
    want = np.asarray(pair_counts_jnp(
        jnp.asarray(pk.plane0[a]), jnp.asarray(pk.plane0[b]),
        None if p1 is None else jnp.asarray(p1[a]),
        None if p1 is None else jnp.asarray(p1[b])))
    got = port.pair_counts_plain(
        _t(pk.plane0[a]), _t(pk.plane0[b]),
        None if p1 is None else _t(p1[a]), None if p1 is None else _t(p1[b]))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.max() > 0  # the corpus has real overlaps


@pytest.mark.parametrize("use64", [False, True], ids=["1plane", "2plane"])
def test_plain_counts_match_pallas_interpret(use64):
    """The Pallas kernel itself (interpret mode) against the plain K4."""
    _, pk = _packed(use64, n=16, pad_n_to=8)
    block = pk.row_block(0, 8)
    want = np.asarray(pair_counts_row(block, pk, gj_tile=8,
                                      backend="interpret"))
    got = port.pair_counts_row(
        _t(block.plane0), _t(pk.plane0),
        None if pk.plane1 is None else _t(block.plane1),
        None if pk.plane1 is None else _t(pk.plane1))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
def test_tiles_and_epilogue_match_jax_batch(use64):
    """pair_counts_tiles + the mask epilogue against the JAX batch program:
    a padded tail (n=200 in n_pad=256), start_index > 0 and an invalid
    batch slot."""
    n, rb, start = 200, 128, 50
    hashes, pk = _packed(use64, n=n, s=100, pad_n_to=rb, seed=11)
    radio = size_ratio_limit(0.05, 21 - 1)
    r0s = np.array([0, 128, 128, 0], dtype=np.int32)
    c0s = np.array([0, 0, 128, 0], dtype=np.int32)
    val = np.array([1, 1, 1, 0], dtype=np.int32)
    p0 = jnp.asarray(pk.plane0)
    p1 = jnp.asarray(pk.plane1) if use64 else p0[:1]
    want_cnt, want_packs = jax_engine._jitted_mst_batch()(
        p0, p1, jnp.asarray(pk.sizes), jnp.asarray(r0s), jnp.asarray(c0s),
        jnp.asarray(val), jnp.int32(radio), jnp.int32(start), jnp.int32(n),
        use64, "jnp", rb)
    planes = planes_to_device(pk, CPU)
    cnt, packs = port_engine._mst_batch(planes, r0s, c0s, val, radio, start,
                                        n, rb)
    assert cnt.dtype == torch.int32 and packs.dtype == torch.uint8
    assert np.array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert np.array_equal(packs.numpy(), np.asarray(want_packs))
    assert int(cnt.sum()) > 0
    # the raw tile counts are the reference's pair counts
    counts = port.pair_counts_tiles(planes.plane0, planes.plane1, r0s, c0s,
                                    val, rb)
    ref = np.asarray(pair_counts_jnp(
        p0[128:256], p0[0:128], p1[128:256] if use64 else None,
        p1[0:128] if use64 else None))
    assert np.array_equal(counts[1].numpy(), ref)
    assert not counts[3].any()


@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
def test_pair_common_plain_matches_jax(use64):
    _, pk = _packed(use64, n=40)
    rng = np.random.default_rng(0)
    q = 2048 * 2
    ii = rng.integers(0, 40, size=q).astype(np.int32)
    jj = rng.integers(0, 40, size=q).astype(np.int32)
    p0 = jnp.asarray(pk.plane0)
    p1 = jnp.asarray(pk.plane1) if use64 else p0[:1]
    want = np.asarray(jax_engine._jitted_pair_common()(
        p0, p1, jnp.asarray(ii), jnp.asarray(jj), use64, 2048))
    planes = planes_to_device(pk, CPU)
    got = port.pair_common(planes.plane0, planes.plane1, ii[:3000],
                           jj[:3000])
    assert np.array_equal(got.numpy(), want[:3000])
    assert (want > 0).any()


def test_pack_mask_u8_byte_equal():
    rng = np.random.default_rng(4)
    masks = rng.random((3, 64, 128)) < 0.3
    got = port_bitmap.pack_mask_u8(torch.from_numpy(masks))
    for t in range(3):
        want = np.asarray(jax_bitmap.pack_mask_u8(jnp.asarray(masks[t])))
        assert np.array_equal(got[t].numpy(), want)
        assert np.array_equal(
            np.unpackbits(got[t].numpy(), axis=1, bitorder="little"),
            masks[t])


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device(CPU) == CPU


def test_wrappers_validate_inputs():
    _, pk = _packed(False, n=40)
    planes = planes_to_device(pk, CPU)
    with pytest.raises(ValueError, match="leaves"):
        port.pair_counts_tiles(planes.plane0, None, [0], [32], [1], 16)
    with pytest.raises(ValueError, match="outside"):
        port.pair_common(planes.plane0, None, [0], [40])
    with pytest.raises(ValueError, match="differ"):
        port.pair_common(planes.plane0, None, [0, 1], [2])
    # an invalid slot is never bounds-checked nor computed
    out = port.pair_counts_tiles(planes.plane0, None, [0, 999], [0, 999],
                                 [1, 0], 8)
    assert not out[1].any()


def test_planes_to_device_views_without_copying_values():
    _, pk = _packed(True, n=20)
    planes = planes_to_device(pk, CPU)
    assert planes.two_plane
    assert planes.plane0.dtype == torch.int32
    assert np.array_equal(planes.plane0.numpy().view(np.uint32), pk.plane0)
    assert np.array_equal(planes.plane1.numpy().view(np.uint32), pk.plane1)
    assert np.array_equal(planes.sizes.numpy(), pk.sizes)
