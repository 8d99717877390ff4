"""The WMH / HLL / OMH arm of the port's clust-mst on the CPU against the
JAX package: the sketchers' copies, the plain K8 (``tuple_matches_plain``,
and its two passes ``tuple_ids_plain`` and ``match_ids_plain``) against
JAX's ``pairwise_tuple_matches``, K8's tile walk (``match_tiles``), the
float64 distance matrices, and the ``--sketch-func`` ``.cluster`` files
byte-equal to the JAX CLI's.
"""

import random

import numpy as np
import pytest
import torch

from rabbittclust_tpu import workflows_extra as jax_wx
from rabbittclust_tpu.cli.clust_mst import main as jax_main
from rabbittclust_tpu.ops import extra_pairs as jax_xp
from rabbittclust_tpu.sketch import extra as jax_extra
from rabbittclust_tpu_torch import workflows_extra as port_wx
from rabbittclust_tpu_torch.cli.clust_mst import main as port_main
from rabbittclust_tpu_torch.ops import extra_pairs as port_xp
from rabbittclust_tpu_torch.sketch import extra as port_extra
from tests.helpers import make_clustered_genomes, mutate, rand_seq
from torch_port_data import planted_tokens

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def genomes():
    """Six genomes of two records each: three near copies of one ancestor,
    three unrelated."""
    rng = random.Random(11)
    a = rand_seq(rng, 6000)
    out = []
    for g in range(6):
        seq = mutate(rng, a, 0.01) if g < 3 else rand_seq(rng, 6000)
        out.append([seq[:3500].encode(), seq[3500:].encode()])
    return out


def _sketch_fns(side_extra, side_wx):
    return {"WMH": side_extra.wminhash_sketch_multi,
            "HLL": side_wx._hll_sketch_multi,
            "OMH": side_wx._omh_sketch_multi}


def _fields(sk):
    return [getattr(sk, f) for f in ("idx", "y", "registers", "vectors")
            if hasattr(sk, f)]


@pytest.mark.parametrize("func", ["WMH", "HLL", "OMH"])
def test_sketchers_equal_jax(func, genomes):
    """WMH idx / y, HLL registers and OMH vectors of the port's copies equal
    the JAX package's, for multi-record genomes and, against JAX's
    single-sequence sketchers, one record."""
    port_fn = _sketch_fns(port_extra, port_wx)[func]
    jax_fn = _sketch_fns(jax_extra, jax_wx)[func]
    single = {"WMH": "wminhash_sketch", "HLL": "hll_sketch",
              "OMH": "omh_sketch"}[func]
    for seqs in genomes[:4]:
        for got, want in ((port_fn(seqs, 21), jax_fn(seqs, 21)),
                          (port_fn(seqs[:1], 19),
                           getattr(jax_extra, single)(seqs[0], 19))):
            for a, b in zip(_fields(got), _fields(want)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("s,c", [(50, 4), (64, 6)], ids=["WMH", "OMH"])
def test_tuple_matches_plain_equals_jax(s, c):
    """At N = 700 (not a multiple of JAX's 512-row block) the plain K8 and
    the host entry equal JAX's device program element for element."""
    tok = planted_tokens(700, s, c, seed=s)
    want = jax_xp.pairwise_tuple_matches(tok, device=True)
    got = port_xp.tuple_matches_plain(
        torch.from_numpy(tok.view(np.int32))).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert want.min() == 0 and want[2, 3] == s and want.max() == s
    assert np.array_equal(port_xp.pairwise_tuple_matches(tok, device=CPU),
                          want)
    assert port_xp.pairwise_tuple_matches(
        tok[:0], device=CPU).shape == (0, 0)


def adversarial_tokens(kind, n=300, s=9, c=3, seed=5):
    """(n, s, c) uint32 tokens that stress the id pass: every row equal,
    every row distinct, or rows in groups of 5 that differ from their
    group's base only in the last word or only in the first."""
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.broadcast_to(rng.integers(0, 2 ** 32, (1, s, c),
                                            dtype=np.uint64).astype(
            np.uint32), (n, s, c)).copy()
    tok = rng.integers(0, 2 ** 32, (n, s, c), dtype=np.uint64).astype(
        np.uint32)
    if kind == "distinct":
        return tok
    word = {"last": c - 1, "first": 0}[kind]
    base = tok[::5].repeat(5, axis=0)[:n]
    flip = rng.random((n, s)) < 0.5
    base[:, :, word] ^= flip.astype(np.uint32) * np.uint32(1 + (
        np.arange(n) % 5)[:, None] * 0x10001)
    return base


TOKEN_CASES = {"WMH": lambda: planted_tokens(700, 50, 4, seed=50),
               "OMH": lambda: planted_tokens(700, 64, 6, seed=64),
               "equal": lambda: adversarial_tokens("equal"),
               "distinct": lambda: adversarial_tokens("distinct"),
               "last_word": lambda: adversarial_tokens("last"),
               "first_word": lambda: adversarial_tokens("first")}


@pytest.mark.parametrize("case", list(TOKEN_CASES))
def test_tuple_ids_plain_then_counts_equal_jax(case):
    """K8's two passes' plain versions: each id is the smallest row with
    the same words at that sample (ids equal exactly where the tokens are),
    and the counts rebuilt from the ids equal JAX's
    ``pairwise_tuple_matches`` element for element, at N = 700 at the WMH
    and OMH shapes and on adversarial tokens."""
    tok = TOKEN_CASES[case]()
    n, s, _ = tok.shape
    ids = port_xp.tuple_ids_plain(torch.from_numpy(tok.view(np.int32)))
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (s, n)
    got = ids.numpy()
    for q in range(s):
        # a row's id is the first row of its class
        _, first, inv = np.unique(tok[:, q, :], axis=0, return_index=True,
                                  return_inverse=True)
        assert np.array_equal(got[q], first[inv.ravel()])
    same = (tok[:, None] == tok[None]).all(-1)  # (n, n, s)
    assert np.array_equal(got.T[:, None] == got.T[None], same)
    want = jax_xp.pairwise_tuple_matches(tok, device=True)
    counts = port_xp.match_ids_plain(ids).numpy()
    assert counts.dtype == np.int32 and np.array_equal(counts, want)
    assert np.array_equal(port_xp.tuple_matches(
        torch.from_numpy(tok.view(np.int32))).numpy(), want)
    n_classes = {"equal": 1, "distinct": n}.get(case)
    if n_classes is not None:
        assert all(len(np.unique(got[q])) == n_classes for q in range(s))
    if case in ("last_word", "first_word"):
        assert 0 < want[0, 1] < s and want[0, 5] <= 1  # near copies


@pytest.mark.parametrize("n", [1, 63, 127, 128, 129, 700, 4100, 8192])
def test_match_tiles_cover_every_pair_once(n):
    """K8's pair kernel walks the lower triangle's 128 x 128 tiles by a
    formula (``tile_of``); its host mirror gives each tile once with
    bx <= by, and the tiles with their transposes cover every pair once."""
    tiles = port_xp.match_tiles(n)
    nt = -(-n // port_xp.TILE)
    assert len(tiles) == nt * (nt + 1) // 2
    cover = np.zeros((nt, nt), dtype=np.int64)
    for by, bx in tiles:
        assert 0 <= bx <= by < nt
        cover[by, bx] += 1
        if bx != by:
            cover[bx, by] += 1
    assert (cover == 1).all()
    assert tiles == sorted(tiles)  # row by row, as the blocks are numbered


def test_tuple_matches_need_a_card_unless_the_cpu_is_asked():
    """No fallback hides the card: without CUDA the default device
    raises."""
    tok = planted_tokens(20, 8, 2, seed=1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_xp.pairwise_tuple_matches(tok)


@pytest.mark.parametrize("func", ["WMH", "HLL", "OMH"])
def test_pair_distances_equal_jax(func, genomes):
    k = 21
    jax_sk = [_sketch_fns(jax_extra, jax_wx)[func](g, k) for g in genomes]
    port_sk = [_sketch_fns(port_extra, port_wx)[func](g, k)
               for g in genomes]
    want = jax_wx.pair_distances_extra(jax_sk, func, k, device=True)
    got = port_wx.pair_distances_extra(port_sk, func, k, device=CPU)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert got[0, 1] < got[0, 4]


@pytest.mark.parametrize("func", ["WMH", "HLL", "OMH"])
def test_cli_sketch_func_equals_jax(func, tmp_path, monkeypatch):
    """``--sketch-func`` on the planted corpus of
    tests/test_extra_sketches.py: the .cluster file byte-equal to the JAX
    CLI's, and the planted clusters recovered."""
    g = make_clustered_genomes(tmp_path, n_clusters=3, per_cluster=3,
                               length=12000, mutation=0.005, seed=9)
    monkeypatch.chdir(tmp_path)
    thr = {"WMH": "0.5", "HLL": "0.05", "OMH": "0.2"}[func]
    argv = ["--sketch-func", func, "-l", "-i", g.list_file, "-d", thr,
            "-m", "1000"]
    jax_out, port_out = tmp_path / "jax.cluster", tmp_path / "port.cluster"
    assert jax_main(argv + ["-o", str(jax_out)]) == 0
    stats = {}
    assert port_main(argv + ["-o", str(port_out)], device=CPU,
                     stats=stats) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert set(stats) == {"sketch_s", "pairs_s", "kruskal_s"}
    from tests.helpers import parse_cluster_file
    clusters = parse_cluster_file(str(port_out))
    assert sorted(sorted(c) for c in clusters) == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8]]


@pytest.mark.parametrize("extra", [
    ["--fast"], ["--presketched", "dir"], ["--premsted", "dir"],
    ["--append", "x.list", "--presketched", "dir"], ["--db", "rep.db"]],
    ids=["fast", "presketched", "premsted", "append", "db"])
def test_cli_sketch_func_fresh_input_only(extra, tmp_path, capsys):
    """JAX's error for the arms the extra sketches do not take, before any
    device is asked for."""
    argv = ["--sketch-func", "OMH", "-o", str(tmp_path / "o.cluster")]
    assert port_main(argv + extra) == 1
    assert "supports fresh genome input only" in capsys.readouterr().err
    assert not (tmp_path / "o.cluster").exists()
