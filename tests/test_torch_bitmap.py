"""The port's bitmap filter on the CPU (plain K1 and the stream generator)
against the JAX package: per-tile counts equal, packed masks byte-equal,
candidate blocks equal and in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbittclust_tpu.ops import bitmap as jax_bm
from rabbittclust_tpu_torch.ops import bitmap as port_bm
from torch_port_data import clustered_sketches, containment_sketches

CPU = torch.device("cpu")
RB = 128
# 300 genomes pad to 384: the last row block is padded; the last slot is
# a valid == 0 padding slot
TILES = [np.array(x, dtype=np.int32) for x in (
    [0, 128, 256, 256, 128, 0], [0, 0, 128, 256, 128, 0],
    [1, 1, 1, 1, 1, 0])]


def _corpus(containment, use64):
    if containment:
        hashes = containment_sketches(300)
    else:
        hashes = clustered_sketches(n=300, s=150, n_clusters=10)
    if use64:
        hashes = [np.unique(h.astype(np.uint64) * np.uint64(2654435761))
                  for h in hashes]
    return hashes


@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
@pytest.mark.parametrize("containment", [False, True], ids=["mash", "aaf"])
@pytest.mark.parametrize("bound", ["mst", "greedy", "minhash"])
def test_batched_mask_plain_equals_jax(bound, containment, use64):
    hashes = _corpus(containment, use64)
    xp, coll = jax_bm.pack_bitmaps_packed(hashes, bits=1024, pad_n_to=RB)
    sizes = np.zeros(xp.shape[0], dtype=np.int32)
    sizes[:300] = [len(h) for h in hashes]
    # minhash: the column side carries other (reference param) sizes
    sd = np.stack([sizes, np.roll(sizes, 7)]) if bound == "minhash" \
        else sizes
    num, den, c_min, radio = port_bm.filter_scalars(0.05, 21, bound)
    want_c, want_p = jax_bm._jitted_batched_mask()(
        jnp.asarray(xp), jnp.asarray(coll), jnp.asarray(sd),
        *map(jnp.asarray, TILES), jnp.float32(num), jnp.float32(den),
        jnp.float32(c_min),
        (jnp.int32 if bound == "mst" else jnp.float32)(radio),
        containment, RB, bound)
    got_c, got_p = port_bm.batched_mask(
        torch.from_numpy(xp), torch.from_numpy(coll), torch.from_numpy(sd),
        *TILES, num, den, c_min, radio, containment, RB, bound)
    assert got_c.dtype == torch.int32 and got_p.dtype == torch.uint8
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_p.numpy().tobytes() == np.asarray(want_p).tobytes()
    assert int(np.asarray(want_c).sum()) > 0
    assert int(np.asarray(want_c)[-1]) == 0


def test_batched_mask_rejects_unknown_bound():
    x = torch.zeros((128, 16), dtype=torch.uint8)
    c = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="bound"):
        port_bm.batched_mask(x, c, c, [0], [0], [1], 0.5, 1.5, 0.3, 2,
                             False, 128, "exact")


# 600 genomes at row_block 64 pad to 640: 55 tiles, four K1 batches of 16
# tiles (the last one padded) on both sides
N_BLOCKS = 600
BLOCK_CASES = {
    "mst": dict(hashes=lambda: clustered_sketches(n=N_BLOCKS), kw={}),
    "mst_64bit": dict(hashes=lambda: clustered_sketches(
        n=N_BLOCKS, dtype=np.uint64), kw={}),
    "containment": dict(hashes=lambda: containment_sketches(N_BLOCKS),
                        kw=dict(is_containment=True)),
    "markers": dict(hashes=lambda: clustered_sketches(n=N_BLOCKS),
                    kw=dict(markers=True)),
    "minhash_markers": dict(
        hashes=lambda: clustered_sketches(n=N_BLOCKS),
        kw=dict(bound="minhash", markers=True, col_sizes="roll")),
    "greedy": dict(hashes=lambda: clustered_sketches(n=N_BLOCKS),
                   kw=dict(bound="greedy")),
}


def _blocks(gen):
    out = []
    for item in gen:
        if isinstance(item[0], str):
            out.append(item)
        else:
            ii, jj = item
            out.append(("pairs", ii.dtype.str, ii.tobytes(), jj.tobytes()))
    return out


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_candidate_pair_blocks_equal_to_jax(case, monkeypatch):
    """RTC_PULL_MODE=mask pins the JAX side to packed-mask pulls, the
    port's only pull; the 55 tiles take several batches at both sides'
    default batch size, so markers interleave with blocks."""
    monkeypatch.setenv("RTC_PULL_MODE", "mask")
    hashes = BLOCK_CASES[case]["hashes"]()
    kw = dict(BLOCK_CASES[case]["kw"])
    if kw.get("col_sizes") == "roll":
        kw["col_sizes"] = np.roll([len(h) for h in hashes], 5)
    args = (hashes, 0.05, 21)
    common = dict(bits=1024, row_block=64, **kw)
    want = _blocks(jax_bm.candidate_pair_blocks(*args, **common))
    port_bm.reset_pull_stats()
    got = _blocks(port_bm.candidate_pair_blocks(*args, device=CPU,
                                                **common))
    assert got == want
    assert sum(1 for b in want if b[0] == "pairs") > 1
    assert any(b[0] == "panel" for b in want) == bool(kw.get("markers"))
    # a count pull per batch: four batches
    assert port_bm.PULL_STATS["pulls"] >= 4


def _filter_args(hashes, bits, rb, tiles):
    xp, coll = jax_bm.pack_bitmaps_packed(hashes, bits=bits, pad_n_to=rb)
    sizes = np.zeros(xp.shape[0], dtype=np.int32)
    sizes[:len(hashes)] = [len(h) for h in hashes]
    num, den, c_min, radio = port_bm.filter_scalars(0.05, 21)
    jax_args = (jnp.asarray(xp), jnp.asarray(coll), jnp.asarray(sizes),
                jnp.arange(len(tiles[0]), dtype=jnp.int32),
                *map(jnp.asarray, tiles), jnp.float32(num), jnp.float32(den),
                jnp.float32(c_min), jnp.int32(radio), False)
    port_args = (torch.from_numpy(xp), torch.from_numpy(coll),
                 torch.from_numpy(sizes), np.arange(len(tiles[0])), *tiles,
                 num, den, c_min, radio, False)
    return jax_args, port_args


# (label, rb, tiles (r0s, c0s, valid), cap_tile, cap_chunks): 300 genomes
# pad to 512 at rb 256 (the 256-wide chunk grid has 256 rows, and no tile
# has a set bit in all of them) and to 384 at rb 128
RB256 = [np.array(x, dtype=np.int32) for x in (
    [0, 256, 256, 0], [0, 0, 256, 0], [1, 1, 1, 0])]
FILTER_CASES = [
    # two-level branch, the last slot a padding tile: the tail after the
    # total is all -1
    ("two_level_padding", 256, RB256, 20000, 255),
    # every slot a real tile: the last tile's encoded padding stays past
    # the total, as the JAX scan leaves it
    ("two_level_full", 256, [t[:3] for t in RB256], 20000, 255),
    # flat-nonzero branch: cap_chunks covers the whole chunk grid
    ("flat", 256, RB256, 20000, 1 << 20),
    # cap_chunks below the hit chunks: the JAX program drops indices, and
    # its plain copy drops the same ones (the CUDA wrapper refuses this)
    ("truncating", 128, TILES, 4096, 64),
]


@pytest.mark.parametrize("case", FILTER_CASES, ids=[c[0] for c in FILTER_CASES])
def test_batched_filter_plain_equals_jax(case):
    """The plain K1 + K3 program against the JAX ``_batched_filter_fn``:
    the whole fused buffer equal, head, indices and tail."""
    label, rb, tiles, cap_tile, cap_chunks = case
    hashes = clustered_sketches(n=300, s=150, n_clusters=10)
    jax_args, port_args = _filter_args(hashes, 2048, rb, tiles)
    want = np.asarray(jax_bm._jitted_batched_filter()(
        *jax_args, cap_tile, cap_chunks, rb, "mst"))
    got = port_bm.batched_filter(*port_args, cap_tile, cap_chunks, rb)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    total = int(want[0])
    assert total > 0 and int(want[1]) <= cap_tile
    tail = want[2 + total:]
    assert (tail == -1).all() == (label != "two_level_full")
    # the indices: the tiles' set bits in order, as K3 writes them
    counts, packs = port_bm.batched_mask(*port_args[:3], *port_args[4:], rb)
    sel = [t for t in range(len(tiles[0])) if tiles[2][t]]
    indices = port_bm.compact_masks(packs, counts.numpy(), sel).numpy()
    assert len(indices) == total
    assert np.array_equal(got[2:2 + total].numpy(), indices) == \
        (label != "truncating")


@pytest.mark.parametrize("shape,density", [
    ((1024, 1024), 1e-4), ((512, 2048), 3e-4), ((1024, 1024), 0.0)])
def test_compact_mask_two_level_plain_equals_jax(shape, density):
    """The three masks of the JAX package's own two-level test
    (``tests/test_device_engine.py``), through both two-level programs:
    count and the whole padded index array equal."""
    rng = np.random.default_rng(7)
    mask = rng.random(shape) < density
    want_c, want_f = jax_bm.compact_mask_two_level(jnp.asarray(mask), 1 << 12,
                                                   512)
    got_c, got_f = port_bm.compact_mask_two_level_plain(
        torch.from_numpy(mask), 1 << 12, 512)
    assert int(got_c) == int(want_c) == int(mask.sum())
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_f.numpy()[:int(mask.sum())],
                          np.flatnonzero(mask))


def test_k3_rejects_int32_wrap():
    """k * rb^2 >= 2^31 (16 tiles of 16384^2, or 8 tiles of 16384^2) is
    refused before anything runs, where the JAX indices would wrap."""
    packs = torch.zeros((1, 16384, 2048), dtype=torch.uint8).expand(
        8, -1, -1)
    with pytest.raises(ValueError, match="int32"):
        port_bm.compact_masks(packs, np.ones(8, dtype=np.int64), [0])
    x = torch.zeros((128, 16), dtype=torch.uint8)
    c = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        port_bm.batched_filter(x, c, c, np.arange(16), [0] * 16, [0] * 16,
                               [1] * 16, 0.5, 1.5, 0.3, 2, False, 16, 16,
                               16384)


def test_pull_mode_bogus_raises(monkeypatch):
    monkeypatch.setenv("RTC_PULL_MODE", "bogus")
    with pytest.raises(ValueError, match="RTC_PULL_MODE"):
        next(port_bm.candidate_pair_blocks(
            clustered_sketches(n=50), 0.05, 21, bits=1024, device=CPU))


@pytest.mark.parametrize("batch", ["16", "3"])
@pytest.mark.parametrize("case", ["mst", "containment", "markers"])
def test_candidate_pair_blocks_idx_equal_to_jax(case, batch, monkeypatch):
    """RTC_PULL_MODE=idx on both sides: the same blocks (one per batch) in
    the same order; concatenated, the same sequence as under ``mask``.
    RTC_BATCH_TILES=3 gives the JAX side batches of 3 tiles, the last one
    padded; the port's batch follows it here (``BATCH_TILES``)."""
    monkeypatch.setenv("RTC_BATCH_TILES", batch)
    monkeypatch.setattr(port_bm, "BATCH_TILES", int(batch))
    hashes = BLOCK_CASES[case]["hashes"]()
    kw = dict(BLOCK_CASES[case]["kw"])
    args = (hashes, 0.05, 21)
    common = dict(bits=2048, row_block=64, **kw)
    seqs = {}
    for mode in ("idx", "mask"):
        monkeypatch.setenv("RTC_PULL_MODE", mode)
        want = _blocks(jax_bm.candidate_pair_blocks(*args, **common))
        port_bm.reset_pull_stats()
        got = _blocks(port_bm.candidate_pair_blocks(*args, device=CPU,
                                                    **common))
        assert got == want, mode
        pairs = [b for b in got if b[0] == "pairs"]
        seqs[mode] = (b"".join(b[2] for b in pairs),
                      b"".join(b[3] for b in pairs))
        if mode == "idx":
            # 4 bytes pulled a candidate beside the counts
            n_cand = len(seqs[mode][0]) // 8
            assert port_bm.PULL_STATS["bytes"] == 4 * n_cand + \
                4 * int(batch) * (port_bm.PULL_STATS["pulls"] - len(pairs))
    assert seqs["idx"] == seqs["mask"]
    assert len(seqs["idx"][0]) > 0


def test_candidate_pairs_threshold_equal_to_jax(monkeypatch):
    hashes = clustered_sketches(n=400, s=150, n_clusters=10)
    for mode in ("mask", "idx"):
        monkeypatch.setenv("RTC_PULL_MODE", mode)
        want = jax_bm.candidate_pairs_threshold(hashes, 0.05, 21, bits=2048,
                                                row_block=128)
        got = port_bm.candidate_pairs_threshold(hashes, 0.05, 21, bits=2048,
                                                row_block=128, device=CPU)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), mode
        assert len(got[0]) > 0


def _k3_inputs():
    """K1's plain counts and packed masks over TILES, and the JAX
    program's indices of the same tiles (slot t encoded t * rb^2)."""
    hashes = clustered_sketches(n=300, s=150, n_clusters=10)
    jax_args, port_args = _filter_args(hashes, 2048, RB, TILES)
    fused = np.asarray(jax_bm._jitted_batched_filter()(
        *jax_args, 20000, 1 << 20, RB, "mst"))
    counts, packs = port_bm.batched_mask(*port_args[:3], *port_args[4:], RB)
    return counts, packs, fused[2:2 + int(fused[0])]


@pytest.mark.parametrize("limit", ["zero", "short", "exact", "over"])
@pytest.mark.parametrize("codes", ["slots", "local", "ints", "sel"])
def test_compact_masks_into_plain_limit_and_total(codes, limit):
    """The contract of K3's non-syncing entry on its plain version: the
    indices in order up to ``limit`` and nothing written past it, and the
    head [total, largest count] counts every set bit also when ``limit``
    falls short.  Exact: against the JAX ``_batched_filter_fn``'s indices
    re-encoded for each ``codes`` form."""
    counts, packs, want = _k3_inputs()
    rb2 = RB * RB
    cnt = counts.numpy()
    total = int(cnt.sum())
    slot, local = want // rb2, want % rb2
    sel = None
    if codes == "slots":
        enc = want
    elif codes == "local":
        enc = local
    elif codes == "ints":
        codes_v = np.arange(len(cnt)) * 3 + 1
        enc = codes_v[slot] * rb2 + local
    else:  # a permuted selection, numbered by its places
        sel = [4, 0, 2, 1, 3]
        place = {t: q for q, t in enumerate(sel)}
        order = np.argsort([place[t] for t in slot], kind="stable")
        enc = np.array([place[t] for t in slot])[order] * rb2 + local[order]
        total = int(cnt[sel].sum())
    n = {"zero": 0, "short": total // 3, "exact": total,
         "over": total + 7}[limit]
    out = torch.full((total + 16,), -7, dtype=torch.int32)
    head = torch.empty(2, dtype=torch.int32)
    got = port_bm.compact_masks_into(
        packs, counts, out, n, codes=codes_v if codes == "ints" else
        ("slots" if codes == "sel" else codes), sel=sel, head=head)
    assert got is head
    assert head.tolist() == [total, int(cnt.max())]
    m = min(n, total)
    assert np.array_equal(out[:m].numpy(), enc[:m])
    assert (out[m:] == -7).all()


def test_compact_masks_into_plain_skips_tiles_counted_zero():
    """A tile whose count is 0 is not read, whatever its mask holds (the
    kernel's blocks of such a tile stop before loading it): its bits are
    missing from the output and the next tile starts where it would
    have."""
    counts, packs, want = _k3_inputs()
    cnt = counts.clone()
    cnt[1] = 0
    out = torch.full((len(want),), -7, dtype=torch.int32)
    total = port_bm.compact_masks_into(packs, cnt, out, len(want))
    keep = want // (RB * RB) != 1
    assert int(total[0]) == int(keep.sum())
    assert np.array_equal(out[:int(keep.sum())].numpy(), want[keep])


@pytest.mark.parametrize("selection", ["every", "sel"])
def test_k3_capacity_grows_once_and_is_kept(selection, monkeypatch):
    """``compact_sized`` from a capacity of 4 entries: the first call
    outgrows its ``k3_buffer`` and launches K3 once more
    (``k3_complete``), into a buffer that becomes the device's capacity,
    so the second call launches once; both equal the JAX program's
    indices (exact).  ``k3_buffer`` hands back a buffer that holds the
    capacity and replaces one that does not."""
    monkeypatch.setattr(port_bm, "K3_START_CAPACITY", 4)
    monkeypatch.setattr(port_bm, "_K3_CAPACITY", {})
    counts, packs, want = _k3_inputs()
    sel = None if selection == "every" else [0, 2, 3]
    if sel is not None:
        want = want[np.isin(want // (RB * RB), sel)]
        want = np.searchsorted(sel, want // (RB * RB)) * RB * RB + \
            want % (RB * RB)
    assert len(want) > 4
    port_bm.reset_launches()
    for relaunches in (1, 1):
        got = port_bm.compact_sized(packs, counts, sel=sel)
        assert port_bm.RELAUNCHES["mask_compact"] == relaunches
        assert np.array_equal(got.numpy(), want)
    held = port_bm.k3_buffer(CPU)
    assert held.numel() == len(want)
    assert port_bm.k3_buffer(CPU, held) is held
    assert port_bm.k3_buffer(CPU, held[:4]).numel() == len(want)


@pytest.mark.parametrize("case", FILTER_CASES[:3],
                         ids=[c[0] for c in FILTER_CASES[:3]])
def test_batched_filter_buffer_from_compact_masks_into(case):
    """The card's ``batched_filter`` buffer built on the CPU the way the
    card builds it (a -1 buffer, K3 writing the head [total, largest
    count], the indices at codes ``ts`` and the last tile's encoded
    padding) against the JAX ``_batched_filter_fn``'s whole buffer: exact,
    for every sizing under which the card does not refuse."""
    label, rb, tiles, cap_tile, cap_chunks = case
    hashes = clustered_sketches(n=300, s=150, n_clusters=10)
    jax_args, port_args = _filter_args(hashes, 2048, rb, tiles)
    want = np.asarray(jax_bm._jitted_batched_filter()(
        *jax_args, cap_tile, cap_chunks, rb, "mst"))
    counts, packs = port_bm.batched_mask(*port_args[:3], *port_args[4:], rb)
    ts, valid = np.arange(len(tiles[0])), tiles[2]
    k = len(ts)
    out = torch.full((2 + k * cap_tile,), -1, dtype=torch.int32)
    pad = (cap_tile, int(ts[-1]) * rb * rb - 1) if valid[-1] else None
    port_bm.compact_masks_into(packs, counts, out[2:], k * cap_tile,
                               codes=ts, head=out[:2], pad=pad)
    assert np.array_equal(out.numpy(), want)


@pytest.mark.parametrize("case", ["mst", "markers"])
def test_candidate_pair_blocks_idx_grows_from_capacity_one(case,
                                                           monkeypatch):
    """RTC_PULL_MODE=idx with K3's buffers starting at one entry: every
    batch with candidates outgrows its buffer at first, so the generator
    takes its grow-and-launch-again branch; the blocks equal the JAX
    generator's under idx, and their concatenation the port's mask pull.
    Exact."""
    monkeypatch.setattr(port_bm, "K3_START_CAPACITY", 1)
    monkeypatch.setattr(port_bm, "_K3_CAPACITY", {})
    hashes = BLOCK_CASES[case]["hashes"]()
    kw = dict(BLOCK_CASES[case]["kw"])
    args = (hashes, 0.05, 21)
    common = dict(bits=2048, row_block=64, **kw)
    seqs = {}
    for mode in ("idx", "mask"):
        monkeypatch.setenv("RTC_PULL_MODE", mode)
        port_bm.reset_launches()
        got = _blocks(port_bm.candidate_pair_blocks(*args, device=CPU,
                                                    **common))
        if mode == "idx":
            assert got == _blocks(jax_bm.candidate_pair_blocks(*args,
                                                               **common))
            assert port_bm.RELAUNCHES["mask_compact"] >= 1
        else:
            assert port_bm.RELAUNCHES["mask_compact"] == 0
        pairs = [b for b in got if b[0] == "pairs"]
        seqs[mode] = (b"".join(b[2] for b in pairs),
                      b"".join(b[3] for b in pairs))
    assert seqs["idx"] == seqs["mask"] and len(seqs["idx"][0]) > 0
