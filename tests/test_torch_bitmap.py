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
