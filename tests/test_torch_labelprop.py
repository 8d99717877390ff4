"""The port's label-propagation engine on the CPU (plain K2 and the engine)
against the JAX package: round outputs and updated masks element-equal,
the same cluster lists, the same rounds and proposals, and the host
partition (the scenarios of tests/test_labelprop.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbittclust_tpu.cluster.mst import (
    clusters_from_forest,
    compute_mst,
    cut_forest,
)
from rabbittclust_tpu.ops import bitmap as jax_bm
from rabbittclust_tpu.ops import labelprop as jax_lp
from rabbittclust_tpu_torch.ops import bitmap as port_bm
from rabbittclust_tpu_torch.ops import labelprop as port_lp
from torch_port_data import clear_list, clustered_sketches

CPU = torch.device("cpu")
RB = 64


@functools.lru_cache(maxsize=None)
def _jax_round(compact):
    if compact:
        return jax.jit(jax_lp._round_fn_compact,
                       static_argnames=("rb", "span", "cap"))
    return jax.jit(jax_lp._round_fn, static_argnames=("rb",))


def _resident(n=300):
    """JAX-built masks of every triangular tile (one slot invalid); cluster
    members sit side by side, so mask bytes hold several set bits."""
    hashes = clustered_sketches(n=n, n_clusters=6)
    hashes = [hashes[i] for i in np.argsort(np.arange(n) % 6,
                                            kind="stable")]
    xp, coll = jax_bm.pack_bitmaps_packed(hashes, bits=1024, pad_n_to=RB)
    sizes = np.zeros(xp.shape[0], dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    tiles = port_bm.triangle_tiles(xp.shape[0], RB)
    geo = np.array([[r for r, _ in tiles], [c for _, c in tiles],
                    [1] * len(tiles)], dtype=np.int32)
    geo[2, 4] = 0
    num, den, c_min, radio = port_bm.filter_scalars(0.05, 21)
    _, packs = jax_bm._jitted_batched_mask()(
        jnp.asarray(xp), jnp.asarray(coll), jnp.asarray(sizes),
        *map(jnp.asarray, geo), jnp.float32(num), jnp.float32(den),
        jnp.float32(c_min), jnp.int32(radio), False, RB)
    return np.asarray(packs), geo, xp.shape[0]


def _labels(mix, n_pad, rng):
    """K2's label mixes: every genome its own label (round 1 of the
    engine), random labels from 30 values, one label for all (no
    cross-label bit).  The random draw is made for every mix, so the clear
    list drawn after it is the same."""
    random = rng.integers(0, 30, n_pad).astype(np.int32)
    if mix == "distinct":
        return np.arange(n_pad, dtype=np.int32)
    return random if mix == "random" else np.zeros(n_pad, dtype=np.int32)


@pytest.mark.parametrize("labels_mix", ["distinct", "random", "one"])
@pytest.mark.parametrize("cap", [None, 3, 4096],
                         ids=["full", "col_cap_overflow", "compact"])
def test_round_plain_equals_jax(cap, labels_mix):
    packs, geo, n_pad = _resident()
    rng = np.random.default_rng(4)
    labels = _labels(labels_mix, n_pad, rng)
    clr = clear_list(packs, rng)
    targets = clr[:3].T[clr[3] > 0]
    assert len({tuple(t) for t in targets}) < len(targets)  # repeats
    jargs = (jnp.asarray(packs), jnp.asarray(labels),
             *map(jnp.asarray, clr[:3]), jnp.asarray(clr[3], jnp.uint8),
             *map(jnp.asarray, geo))
    mine = torch.from_numpy(packs.copy())
    targs = (torch.from_numpy(labels), torch.from_numpy(clr),
             *map(torch.from_numpy, geo))
    if cap is None:
        want_p, want = _jax_round(False)(*jargs, rb=RB)
        got = port_lp.lp_round(mine, *targs, RB)
    else:
        r_lo, span = 64, 192
        want_p, want = _jax_round(True)(*jargs, jnp.int32(r_lo), rb=RB,
                                        span=span, cap=cap)
        got = port_lp.lp_round_compact(mine, *targs, r_lo, RB, span, cap)
        ncol = int(np.asarray(want)[1])
        assert (ncol > cap) == (cap == 3 and labels_mix != "one")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert mine.numpy().tobytes() == np.asarray(want_p).tobytes()
    assert mine.numpy().tobytes() != packs.tobytes()
    want = np.asarray(want)
    if labels_mix != "one":
        assert want[0] > 0
    elif cap is None:  # no proposal at all
        assert want[0] == 0 and (want[1:] == port_lp.SENT).all()
    else:  # ... and the column list is all padding
        assert want[0] == want[1] == 0
        rows, idx, val = np.split(want[2:], [span, span + cap])
        assert (rows == port_lp.SENT).all() and (val == port_lp.SENT).all()
        assert (idx == 0).all()


def host_partition(hashes, threshold, is_containment=False):
    res = compute_mst(hashes, threshold, 21, is_containment=is_containment)
    return clusters_from_forest(cut_forest(res.mst, threshold), len(hashes))


def canon(clusters):
    return sorted(tuple(sorted(c)) for c in clusters)


def make_sketches(n=300, s=120, n_clusters=12, seed=7, dtype=np.uint32):
    """tests/test_labelprop.py's corpus recipe."""
    return clustered_sketches(n=n, s=s, n_clusters=n_clusters, seed=seed,
                              dtype=dtype, keep=0.8)


def containment_corpus():
    rng = np.random.default_rng(3)
    base = np.unique(rng.integers(0, 2 ** 31, size=400).astype(np.uint32))
    hashes = []
    for _ in range(96):
        take = rng.integers(60, 400)
        sub = rng.choice(base, size=take, replace=False)
        noise = np.unique(rng.integers(0, 2 ** 31, size=take // 4).astype(
            np.uint32))
        hashes.append(np.unique(np.concatenate([sub, noise])))
    return hashes


def lone_corpus():
    rng = np.random.default_rng(11)
    return [np.unique(rng.integers(0, 2 ** 31, size=100).astype(np.uint32))
            for _ in range(40)]


# name: (corpus, threshold, engine keywords, environment)
SCENARIOS = {
    "uint32": (make_sketches, 0.05, dict(bits=2048, row_block=128), {}),
    "uint64": (lambda: make_sketches(dtype=np.uint64), 0.05,
               dict(bits=2048, row_block=128), {}),
    "containment": (containment_corpus, 0.05,
                    dict(bits=2048, row_block=64, is_containment=True), {}),
    "singletons": (lone_corpus, 0.01, dict(bits=1024, row_block=64), {}),
    "one_cluster": (lambda: [lone_corpus()[0].copy() for _ in range(17)],
                    0.05, dict(bits=1024, row_block=64), {}),
    "fallback": (lambda: make_sketches(n=200, seed=5), 0.05,
                 dict(bits=2048, row_block=128, max_rounds=1), {}),
    "false_positives": (lambda: make_sketches(n=160, s=60, n_clusters=8,
                                              seed=9), 0.05,
                        dict(bits=128, row_block=64), {}),
    "panels_1": (lambda: make_sketches(n_clusters=9, seed=13), 0.05,
                 dict(bits=2048, row_block=64, panel_tiles=1), {}),
    "panels_2": (lambda: make_sketches(n_clusters=9, seed=13), 0.05,
                 dict(bits=2048, row_block=64, panel_tiles=2), {}),
    "panels_4": (lambda: make_sketches(n_clusters=9, seed=13), 0.05,
                 dict(bits=2048, row_block=64, panel_tiles=4), {}),
    "panels_false_positives": (
        lambda: make_sketches(n=160, s=60, n_clusters=8, seed=9), 0.05,
        dict(bits=128, row_block=64, panel_tiles=2), {}),
    "panels_fallback": (lambda: make_sketches(n=200, seed=5), 0.05,
                        dict(bits=2048, row_block=64, max_rounds=1,
                             panel_tiles=2), {}),
    "col_cap_overflow": (lambda: make_sketches(n_clusters=9, seed=13), 0.05,
                         dict(bits=2048, row_block=64, panel_tiles=2),
                         {"RTC_LP_COL_CAP": "4"}),
    "no_prefetch": (lambda: make_sketches(n_clusters=9, seed=13), 0.05,
                    dict(bits=2048, row_block=64, panel_tiles=4),
                    {"RTC_LP_PREFETCH": "0"}),
    "label_delta_ignored": (
        lambda: make_sketches(n=160, s=60, n_clusters=8, seed=9), 0.05,
        dict(bits=128, row_block=64, panel_tiles=2),
        {"RTC_LP_LABEL_DELTA": "1", "RTC_LP_COL_CAP": "4"}),
}


def _both(hashes, threshold, kw):
    want = jax_lp.threshold_clusters_device_lp(hashes, threshold, 21, **kw)
    jax_stats = dict(jax_lp.LP_STATS)
    got = port_lp.threshold_clusters_device_lp(hashes, threshold, 21,
                                               device=CPU, **kw)
    return got, want, jax_stats


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_lp_engine_equals_jax(name, monkeypatch):
    corpus, threshold, kw, env = SCENARIOS[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    hashes = corpus()
    got, want, jax_stats = _both(hashes, threshold, kw)
    assert got == want  # the same cluster list, member order included
    for key in ("rounds", "panels", "proposals"):
        assert port_lp.LP_STATS[key] == jax_stats[key], key
    assert canon(got) == canon(host_partition(
        hashes, threshold, kw.get("is_containment", False)))
    if name == "one_cluster":
        assert canon(got) == [tuple(range(17))]


def test_lp_tiny_inputs():
    assert port_lp.threshold_clusters_device_lp([], 0.05, 21,
                                                device=CPU) == []
    one = [np.array([1, 2, 3], dtype=np.uint32)]
    assert port_lp.threshold_clusters_device_lp(
        one, 0.05, 21, bits=1024, row_block=64, device=CPU) == [[0]]


def test_lp_randomized_config_sweep(monkeypatch):
    """tests/test_labelprop.py's randomized sweep over (n, clusters,
    sketch size, bits, panels, col cap, prefetch), each against JAX."""
    rng = np.random.default_rng(0)
    for trial in range(5):
        n = int(rng.integers(150, 450))
        nc = int(rng.integers(3, 20))
        s = int(rng.choice([40, 60, 120]))
        bits = int(rng.choice([128, 512, 2048]))
        pt = int(rng.choice([1, 2, 3, 5]))
        monkeypatch.setenv("RTC_LP_COL_CAP",
                           str(int(rng.choice([4, 64, 100000]))))
        monkeypatch.setenv("RTC_LP_PREFETCH", str(int(rng.integers(0, 2))))
        hashes = make_sketches(n=n, s=s, n_clusters=nc, seed=trial + 100)
        got, want, _ = _both(hashes, 0.05, dict(bits=bits, row_block=64,
                                                panel_tiles=pt))
        assert got == want, f"trial={trial}"
        assert canon(got) == canon(host_partition(hashes, 0.05)), \
            f"trial={trial} n={n} nc={nc} s={s} bits={bits} pt={pt}"


def test_lp_rejects_row_block_k2_cannot_read(monkeypatch):
    """On the card K2 reads rows in 16-byte chunks: the engine rejects a
    row block that is not a multiple of 128 before it stages anything, also
    when ``RTC_CLUSTER_RB`` sets it through the dispatcher."""
    from rabbittclust_tpu_torch import device as port_device
    from rabbittclust_tpu_torch.ops import cluster_fast as port_cf
    monkeypatch.setattr(port_device, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    hashes = [np.array([i, i + 1], dtype=np.uint32) for i in range(5000)]
    with pytest.raises(ValueError, match="multiple of 128"):
        port_lp.threshold_clusters_device_lp(hashes[:300], 0.05, 21,
                                             row_block=160)
    monkeypatch.setenv("RTC_CLUSTER_RB", "4128")
    monkeypatch.setenv("RTC_CLUSTER_ENGINE", "lp")
    with pytest.raises(ValueError, match="row block 4128"):
        port_cf.threshold_clusters_device(hashes, 0.05, 21)


@pytest.mark.parametrize("case", ["rb_direct", "rb_dispatcher",
                                  "panel_tiles"])
def test_lp_rejects_k2_limits_before_staging(monkeypatch, case):
    """On the card K2 takes rb <= 16,384 (the engines' largest row block)
    and at most 65,535 tiles per launch: the engine rejects a row
    block of 32,768 (directly and through ``RTC_CLUSTER_RB`` with
    ``RTC_CLUSTER_ENGINE=lp``) and a panel of more tiles
    (``RTC_LP_PANEL_TILES``) before it stages anything."""
    from rabbittclust_tpu_torch import device as port_device
    from rabbittclust_tpu_torch.ops import cluster_fast as port_cf
    monkeypatch.setattr(port_device, "resolve_device",
                        lambda device: torch.device("cuda", 0))

    def staged(*args, **kwargs):
        raise AssertionError("stage_signatures ran before the check")
    monkeypatch.setattr(port_lp, "stage_signatures", staged)
    one = np.array([1, 2], dtype=np.uint32)
    if case == "rb_direct":
        with pytest.raises(ValueError, match="row block 32768"):
            port_lp.threshold_clusters_device_lp([one] * 20000, 0.05, 21,
                                                 row_block=32768)
    elif case == "rb_dispatcher":
        monkeypatch.setenv("RTC_CLUSTER_RB", "32768")
        monkeypatch.setenv("RTC_CLUSTER_ENGINE", "lp")
        with pytest.raises(ValueError, match="row block 32768"):
            port_cf.threshold_clusters_device([one] * 20000, 0.05, 21)
    else:
        # 362 row blocks of 128: 65,703 triangular tiles in one panel
        monkeypatch.setenv("RTC_LP_PANEL_TILES", "70000")
        with pytest.raises(ValueError, match="65703 tiles"):
            port_lp.threshold_clusters_device_lp([one] * (362 * 128), 0.05,
                                                 21, row_block=128)


@pytest.mark.parametrize("rb,n_tiles", [
    (128, 21), (4096, 512), (4096, 16), (8192, 136), (8320, 4),
    (12416, 3), (16384, 5)])
def test_k2_walk_covers_every_cell_once(rb, n_tiles):
    """K2's blocks (a band of rows by the whole row up to rb 8,192, by a
    span of 4,096 columns above it; each warp a run of the band's rows,
    each lane group its rows' 16-byte chunks) read every (row, column) of a
    tile once, each lane's rows ascending, at the engine's and the mesh
    LP's shapes on an H100's 132 SMs (rb 8,320 and 12,416: a partial span,
    and at 12,416 a partial band)."""
    band = port_lp.lp_band(n_tiles, rb, 132)
    spans = -(-rb // port_lp.lp_span(rb))
    assert spans == (1 if rb <= port_lp.SPAN_FROM else -(-rb // 4096))
    assert band >= (port_lp.SPAN_MIN_BAND if spans > 1
                    else min(rb, port_lp.MIN_BAND))
    chunks = rb // 128
    cover = np.zeros((rb, chunks), dtype=np.int64)  # rows x 128 columns
    for rows, cols in port_lp.lp_walk(rb, band):
        assert rows == sorted(rows)
        c = np.asarray(cols)
        assert len(c) % 128 == 0 and (c[::128] % 128 == 0).all()
        assert np.array_equal(c, (c[::128, None] + np.arange(128)).ravel())
        cover[np.asarray(rows, dtype=np.int64)[:, None],
              c[::128] // 128] += 1
    assert (cover == 1).all()
