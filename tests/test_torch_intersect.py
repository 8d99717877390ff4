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
from rabbittclust_tpu_torch.ops import intersect as port
from rabbittclust_tpu_torch.ops.pack import (GROUP, compact_of,
                                             compact_planes,
                                             pack_sketches as port_pack,
                                             planes_to_device, sort_key)
from torch_port_data import clustered_sketches, shared_sketches

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
    """pair_mask_tiles (plain counts + the mask epilogue on the CPU) and
    pair_counts_tiles against the JAX batch program:
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
    cnt, packs = port.pair_mask_tiles(planes.plane0, planes.plane1,
                                      planes.sizes, r0s, c0s, val, radio,
                                      start, n, rb)
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


# --- the compact form and a plain model of K4's arithmetic over it --------

W_CASES = [(False, None), (False, 3), (True, None), (True, 3)]
W_IDS = ["1plane-W_natural", "1plane-W_wide", "2plane-W_natural",
         "2plane-W_wide"]


def _ragged(use64, bucket_bits=None, seed=3):
    """300 genomes of ~150 hashes (numpy seed ``seed``) in planes padded to
    384 genomes (a padded tail); W_wide: ``bucket_bits=3`` (the bucket
    count adapts upward, so W is large and K small)."""
    dtype = np.uint64 if use64 else np.uint32
    hashes = clustered_sketches(n=300, s=150, n_clusters=8, seed=seed,
                                dtype=dtype)
    pk = port_pack(hashes, use64, bucket_bits=bucket_bits, pad_n_to=128)
    return hashes, pk, planes_to_device(pk, CPU)


def _scatter(g, b, vals, n_pad, w, k):
    """Planes of only pads, then ``vals`` at (genome g, bucket b) in slots
    0, 1, ... in the order the entries come."""
    key = g * k + b
    _, runs = torch.unique_consecutive(key, return_counts=True)
    first = torch.repeat_interleave(torch.cumsum(runs, 0) - runs, runs)
    slot = torch.arange(len(key)) - first
    pad = torch.from_numpy((np.uint32(0x80000000) | np.arange(
        n_pad, dtype=np.uint32)).view(np.int32))
    plane = pad[:, None, None].expand(n_pad, w, k).clone()
    plane[g, slot, b] = vals
    return plane


def _by_key(planes):
    """``planes`` with the W slots of every (genome, bucket) sorted by
    ``sort_key``: the grouped order keeps a cell's entries sorted by value,
    not in slot order, so it rebuilds the planes up to this."""
    key = sort_key(planes[0], planes[1] if len(planes) > 1 else None)
    order = key.argsort(dim=1)
    return [p.gather(1, order) for p in planes]


def _rebuild(cf, n_pad, w, k):
    """The planes again, from each of the two orders of ``cf`` (the
    grouped one with its cells in value order, ``_by_key``)."""
    e = cf.entries
    occ = cf.occ.long()
    g = torch.repeat_interleave(torch.arange(n_pad), occ.sum(1))
    b = torch.repeat_interleave(torch.arange(k).repeat(n_pad),
                                occ.flatten())
    genome_major = [_scatter(g, b, v[:e], n_pad, w, k)
                    for v in (cf.v0, cf.v1) if v is not None]
    gs, bs = [], []
    for grp in range(cf.goff.shape[0]):
        lo, hi = cf.start[grp * GROUP], cf.start[(grp + 1) * GROUP]
        bs.append(torch.repeat_interleave(torch.arange(k),
                                          cf.goff[grp].diff().long()))
        gs.append(grp * GROUP + cf.gid[lo:hi].long())
    g, b = torch.cat(gs), torch.cat(bs)
    cell = torch.sort(g * k + b, stable=True).indices  # a cell's entries
    grouped = [_scatter(g[cell], b[cell], v[:e][cell], n_pad, w, k)
               for v in (cf.g0, cf.g1) if v is not None]
    return genome_major, _by_key(grouped)


@pytest.mark.parametrize("use64,bucket_bits", W_CASES, ids=W_IDS)
def test_compact_form_rebuilds_the_planes(use64, bucket_bits):
    hashes, pk, pl = _ragged(use64, bucket_bits)
    cf = compact_planes(pl.plane0, pl.plane1)
    n_pad, w, k = pl.plane0.shape
    assert cf.entries == sum(len(h) for h in hashes)
    want = [pl.plane0] + ([pl.plane1] if use64 else [])
    for form, planes in zip(_rebuild(cf, n_pad, w, k),
                            (want, _by_key(want))):
        assert len(form) == len(planes)
        for got, plane in zip(form, planes):
            assert torch.equal(got, plane)
    top = pl.plane1 if use64 else pl.plane0
    assert torch.equal(cf.occ.long(), (top >= 0).sum(1))
    assert torch.equal(cf.padsq.long(), ((w - cf.occ.long()) ** 2).sum(1))
    assert int(cf.padsq[-1]) == w * w * k  # a padded tail genome
    # the window maxima bound every window of every group
    for wb, most in cf.window_max.items():
        edges = list(range(0, k, wb)) + [k]
        per = cf.goff[:, edges[1:]] - cf.goff[:, edges[:-1]]
        assert int(per.max()) == most
    if bucket_bits == 3:
        assert pk.width > 16  # the wide case is wide


@pytest.mark.parametrize("use64,bucket_bits", W_CASES, ids=W_IDS)
def test_pack_fills_real_slots_first(use64, bucket_bits):
    """Real slots are 0..occ-1 in ``pack_sketches``' planes (64-bit: the
    test is on plane1, since a real plane0 value may have its top bit
    set), and the compact form does not rely on that order: planes with
    the pads first give the same form."""
    hashes, pk, pl = _ragged(use64, bucket_bits)
    ref = pack_sketches(hashes, use64, bucket_bits=bucket_bits, pad_n_to=128)
    assert np.array_equal(ref.plane0, pk.plane0)  # the JAX package's too
    top = pl.plane1 if use64 else pl.plane0
    real = top >= 0
    assert not (real[:, 1:] & ~real[:, :-1]).any()
    if use64:
        assert (pl.plane0[real] < 0).any()  # why plane0 is no pad test
    # pads first, then the real slots (in reverse)
    flipped = [p.flip(1).contiguous() for p in (pl.plane0, pl.plane1)
               if p is not None]
    real_f = (flipped[-1] >= 0)
    assert (real_f[:, 1:] & ~real_f[:, :-1]).any()  # the order is broken
    want = compact_planes(pl.plane0, pl.plane1)
    got = compact_planes(flipped[0], flipped[1] if use64 else None)
    assert torch.equal(got.occ, want.occ)
    assert torch.equal(got.padsq, want.padsq)
    assert torch.equal(got.goff, want.goff)


def _planted_shared(use64):
    """``shared_sketches``: 200 genomes, planes padded to 256 (a ragged
    tail group)."""
    hashes = shared_sketches(dtype=np.uint64 if use64 else np.uint32)
    pk = port_pack(hashes, use64, pad_n_to=128)
    return hashes, pk, planes_to_device(pk, CPU)


def _grouped_unsorted(pl):
    """The grouped form built in numpy with each (group, bucket) segment in
    genome-then-slot order, the order before its sort: {g0, g1 (or None),
    gid, seg (the segment of each entry), start, goff, occ}."""
    planes = [p.numpy() for p in (pl.plane0, pl.plane1) if p is not None]
    n, w, k = planes[0].shape
    n_groups = -(-n // GROUP)
    n_virt = n_groups * GROUP
    real = np.zeros((n_virt, w, k), dtype=bool)
    real[:n] = planes[-1] >= 0

    def grouped(a):  # (group, bucket, genome, slot)
        return a.reshape(n_groups, GROUP, w, k).transpose(0, 3, 1, 2)

    sel = grouped(real)
    vals = []
    for p in planes:
        full = np.zeros((n_virt, w, k), dtype=np.int32)
        full[:n] = p
        vals.append(grouped(full)[sel])
    occ = real.sum(1)
    goff = np.zeros((n_groups, k + 1), dtype=np.int64)
    goff[:, 1:] = occ.reshape(n_groups, GROUP, k).sum(1).cumsum(1)
    return {"g0": vals[0], "g1": vals[1] if len(vals) > 1 else None,
            "gid": np.broadcast_to(np.arange(GROUP)[None, None, :, None],
                                   sel.shape)[sel],
            "seg": np.broadcast_to(np.arange(n_groups * k).reshape(
                n_groups, k)[:, :, None, None], sel.shape)[sel],
            "start": np.concatenate([[0], occ.sum(1).cumsum()]),
            "goff": goff, "occ": occ[:n]}


SORT_CASES = W_CASES + [(False, "planted"), (True, "planted")]
SORT_IDS = W_IDS + ["1plane-planted_shared", "2plane-planted_shared"]


@pytest.mark.parametrize("use64,corpus", SORT_CASES, ids=SORT_IDS)
def test_compact_segments_sorted_offsets_kept(use64, corpus):
    """Every (group, bucket) segment of the grouped form is sorted by
    ``sort_key`` (unsigned; ``(g1, g0)`` for 64-bit hashes), ties by
    genome: it is the form before the sort (built here in numpy) sorted
    so, and ``start``, ``goff``, ``occ``, ``padsq`` and ``window_max``
    are the unsorted form's.  The planted case holds equal runs of 128
    keys (a value in every genome of a group)."""
    if corpus == "planted":
        _, pk, pl = _planted_shared(use64)
    else:
        _, pk, pl = _ragged(use64, corpus)
    cf = compact_planes(pl.plane0, pl.plane1)
    ref = _grouped_unsorted(pl)
    assert np.array_equal(cf.start.numpy(), ref["start"])
    assert np.array_equal(cf.goff.numpy(), ref["goff"])
    assert np.array_equal(cf.occ.numpy(), ref["occ"])
    w = pk.width
    assert np.array_equal(cf.padsq.numpy(),
                          ((w - ref["occ"]) ** 2).sum(1))
    for wb, most in cf.window_max.items():
        edges = list(range(0, pk.k, wb)) + [pk.k]
        assert most == int((ref["goff"][:, edges[1:]] -
                            ref["goff"][:, edges[:-1]]).max())
    key = (ref["g0"].astype(np.int64) & 0xFFFFFFFF) | (
        0 if ref["g1"] is None else ref["g1"].astype(np.int64) << 32)
    order = np.lexsort((ref["gid"], key, ref["seg"]))
    e = cf.entries
    assert np.array_equal(cf.g0[:e].numpy(), ref["g0"][order])
    assert np.array_equal(cf.gid[:e].numpy(), ref["gid"][order])
    if use64:
        assert np.array_equal(cf.g1[:e].numpy(), ref["g1"][order])
    got = sort_key(cf.g0[:e], cf.g1[:e] if use64 else None)
    same_seg = torch.from_numpy(ref["seg"][1:] == ref["seg"][:-1])
    step = got[1:] - got[:-1]
    gid = cf.gid[:e].long()
    assert ((step > 0) | ((step == 0) & (gid[1:] > gid[:-1])))[
        same_seg].all()
    if corpus == "planted":  # a run of one key over a whole group
        _, runs = torch.unique_consecutive(
            torch.stack([torch.from_numpy(ref["seg"][order]), got]),
            dim=1, return_counts=True)
        assert int(runs.max()) == GROUP


@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
def test_sorted_join_equals_plain_and_pallas(use64):
    """The join the kernel runs, over the sorted grouped form
    (``_join_model``), gives ``pair_counts_plain``'s counts and the JAX
    Pallas kernel's (``pair_counts_row_pallas``, interpret mode) on every
    tile of the planted corpus with shared values: the diagonal with its
    pad term, the ragged tail group, equal runs of up to 128 keys."""
    hashes, pk, pl = _planted_shared(use64)
    jpk = pack_sketches(hashes, use64, pad_n_to=128)
    assert np.array_equal(jpk.plane0, pk.plane0)
    cf = compact_planes(pl.plane0, pl.plane1)
    n_pad = pk.n
    got = _join_model(cf, 0, 0, n_pad)
    want = port.pair_counts_tiles(pl.plane0, pl.plane1, [0], [0], [1],
                                  n_pad)[0]
    assert torch.equal(got, want)
    for r0 in range(0, n_pad, GROUP):
        pallas = np.asarray(pair_counts_row(jpk.row_block(r0, GROUP), jpk,
                                            gj_tile=GROUP,
                                            backend="interpret"))
        assert np.array_equal(got[r0:r0 + GROUP].numpy(), pallas), r0
    assert (want.diagonal()[200:] == pk.width ** 2 * pk.k).all()
    assert int(want[:200, :200].min()) >= 6  # the shared hashes


def _group_entries(cf, g):
    """Group ``g``'s entries in the grouped order: (key, bucket, gid)."""
    k = cf.goff.shape[1] - 1
    lo, hi = int(cf.start[g * GROUP]), int(cf.start[(g + 1) * GROUP])
    key = sort_key(cf.g0[lo:hi], None if cf.g1 is None else cf.g1[lo:hi])
    bucket = torch.repeat_interleave(torch.arange(k),
                                     cf.goff[g].diff().long())
    return key, bucket, cf.gid[lo:hi].long()


def _join_model(cf, r0, c0, rb, mask=None):
    """K4's join in plain torch, the algorithm the kernel runs (for the
    tests): per block of GROUP x GROUP pairs, each real row entry finds
    the first column entry of its key in its bucket's column segment
    (sorted by ``sort_key``) by a binary search and takes the equal run
    from there (its end by the same search on the right; the kernel walks
    it), each entry of the run a match.  The searches of all buckets run
    as one, over the column group's (bucket, key) sequence, which the
    sorted segments make sorted.  Counts: the matches plus padsq on the
    diagonal.  ``mask = (sizes, radio, start_index, n)``: the mask mode
    instead, blocks with no pair j < i or no row in [start_index, n)
    skipped, then the gates; returns (count, packed mask)."""
    hits = torch.zeros((rb, rb), dtype=torch.int32)
    for tr in range(0, rb, GROUP):
        for tc in range(0, rb, GROUP):
            gr, gc = (r0 + tr) // GROUP, (c0 + tc) // GROUP
            if mask is not None:
                start_index, n = mask[2], mask[3]
                i0, j0 = r0 + tr, c0 + tc
                if j0 >= i0 + GROUP - 1 or i0 + GROUP <= start_index \
                        or i0 >= n:
                    continue
            xr, br, idr = _group_entries(cf, gr)
            xc, bc, idc = _group_entries(cf, gc)
            # (bucket, rank of the key among both groups' keys) orders the
            # entries as (bucket, key) does, in an int64
            _, rank = torch.unique(torch.cat([xr, xc]), return_inverse=True)
            span = len(rank) + 1
            pr = br * span + rank[:len(xr)]
            pc = bc * span + rank[len(xr):]
            assert bool((pc[1:] >= pc[:-1]).all())  # sorted segments
            lo = torch.searchsorted(pc, pr, side="left")
            run = torch.searchsorted(pc, pr, side="right") - lo
            ri = torch.repeat_interleave(torch.arange(len(pr)), run)
            first = torch.repeat_interleave(torch.cumsum(run, 0) - run, run)
            ci = lo[ri] + torch.arange(len(ri)) - first
            hits.index_put_((tr + idr[ri], tc + idc[ci]),
                            torch.ones(len(ri), dtype=torch.int32),
                            accumulate=True)
    span = torch.arange(rb)
    if mask is None:
        diag = (r0 + span)[:, None] == (c0 + span)[None, :]
        rows = (r0 + span)[:, None].expand(rb, rb)
        return hits + torch.where(diag, cf.padsq[rows.clamp(max=len(
            cf.padsq) - 1)], 0).to(torch.int32)
    sizes, radio, start_index, n = mask
    i, j = (r0 + span)[:, None], (c0 + span)[None, :]
    si, sj = sizes[i], sizes[j]
    mn, mx = torch.minimum(si, sj), torch.maximum(si, sj)
    m = (hits > 0) & (j < i) & (i < n) & (i >= start_index) & (mn > 0) & \
        (mx <= radio * mn)
    return int(m.sum()), port_bitmap.pack_mask_u8(m)


@pytest.mark.parametrize("use64,bucket_bits", W_CASES, ids=W_IDS)
def test_join_model_equals_plain_counts(use64, bucket_bits):
    """The sorted join of real entries per bucket plus the diagonal pad
    term gives ``pair_counts_plain`` exactly: a diagonal tile, an
    off-diagonal one and the diagonal tile of the padded tail (rows
    300..383 all pads)."""
    _, pk, pl = _ragged(use64, bucket_bits)
    cf = compact_planes(pl.plane0, pl.plane1)
    r0s, c0s = [0, 128, 256, 256], [0, 0, 128, 256]
    want = port.pair_counts_tiles(pl.plane0, pl.plane1, r0s, c0s,
                                  [1] * 4, 128)
    for t, (r0, c0) in enumerate(zip(r0s, c0s)):
        assert torch.equal(_join_model(cf, r0, c0, 128), want[t]), t
    w, k = pk.width, pk.k
    assert (want[3].diagonal()[300 - 256:] == w * w * k).all()
    assert int(want[1].max()) > 0


@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
@pytest.mark.parametrize("start,n", [(0, 300), (150, 300), (50, 237)],
                         ids=["whole", "start_cuts_a_tile", "ragged_n"])
def test_join_model_mask_equals_jax_batch(use64, start, n):
    """The model's mask form against the JAX batch program
    (``_mst_batch_fn``, jnp backend): counts and packed masks byte-equal,
    ``start_index`` cutting through a tile and a ragged ``n`` (numpy seed
    11 corpus of 300 genomes, rb = 128, an invalid slot)."""
    hashes = clustered_sketches(n=300, s=100, n_clusters=5, seed=11,
                                dtype=np.uint64 if use64 else np.uint32)
    pk = pack_sketches(hashes, use64, pad_n_to=128)
    pk.sizes[n:] = 0  # genomes past n are the tail, as in the engine
    rb = 128
    radio = size_ratio_limit(0.05, 21 - 1)
    r0s = np.array([0, 128, 128, 256, 256, 0], dtype=np.int32)
    c0s = np.array([0, 0, 128, 128, 256, 0], dtype=np.int32)
    val = np.array([1, 1, 1, 1, 1, 0], dtype=np.int32)
    p0 = jnp.asarray(pk.plane0)
    p1 = jnp.asarray(pk.plane1) if use64 else p0[:1]
    want_cnt, want_packs = jax_engine._jitted_mst_batch()(
        p0, p1, jnp.asarray(pk.sizes), jnp.asarray(r0s), jnp.asarray(c0s),
        jnp.asarray(val), jnp.int32(radio), jnp.int32(start), jnp.int32(n),
        use64, "jnp", rb)
    pl = planes_to_device(pk, CPU)
    cf = compact_planes(pl.plane0, pl.plane1)
    for t in range(len(r0s)):
        if not val[t]:
            assert int(want_cnt[t]) == 0 and not np.asarray(
                want_packs[t]).any()
            continue
        cnt, packs = _join_model(cf, int(r0s[t]), int(c0s[t]), rb,
                                 mask=(pl.sizes, radio, start, n))
        assert cnt == int(want_cnt[t]), t
        assert np.array_equal(packs.numpy(), np.asarray(want_packs[t])), t
    assert int(np.asarray(want_cnt).sum()) > 0


@pytest.mark.parametrize("use64,bucket_bits", W_CASES, ids=W_IDS)
@pytest.mark.parametrize("mode", [port.COUNTS, port.MASK],
                         ids=["counts", "mask"])
def test_tile_config_fits_shared_memory(use64, bucket_bits, mode):
    """The staging ring holds the fullest window of any group, with the
    granule shift, and the kernel's shared memory fits a block."""
    _, _, pl = _ragged(use64, bucket_bits)
    cf = compact_planes(pl.plane0, pl.plane1)
    wb, cap, smem = port.tile_config(cf, use64, mode)
    assert cap % 16 == 0 and cap >= cf.window_max[wb] + 15
    assert smem <= 232448
    acc = GROUP * GROUP * 4 if mode == port.COUNTS else GROUP * GROUP // 8
    if wb < max(cf.window_max):  # shorter windows only when needed
        assert smem - acc <= port.STAGE_BUDGET


def test_compact_form_is_kept_with_the_planes():
    _, _, pl = _ragged(False)
    cf = pl.compact()
    assert compact_of(pl.plane0, None) is cf
    assert compact_of(pl.plane0, pl.plane0) is not cf  # another plane1
    pl.plane0[0, 0, 0] = 5  # an in-place change builds it again
    assert compact_of(pl.plane0, None) is not cf


def test_compact_form_of_another_layout_is_built_again():
    """A form kept on the planes under another layout (as a package
    without the sorted segments keeps it: no layout in its key) is not
    taken for this layout's; the one built in its place is kept."""
    _, _, pl = _ragged(False)
    old = object()
    pl.plane0._rtc_compact = ((None, pl.plane0._version, None), old)
    cf = compact_of(pl.plane0, None)
    assert cf is not old and compact_of(pl.plane0, None) is cf
    fresh = compact_planes(pl.plane0, None)
    assert torch.equal(cf.g0, fresh.g0) and torch.equal(cf.gid, fresh.gid)
