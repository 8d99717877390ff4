"""The WMH / HLL / OMH arm of the port's clust-mst on the CPU against the
JAX package: the sketchers' copies, the plain K8 (``tuple_matches_plain``)
against JAX's ``pairwise_tuple_matches``, the float64 distance matrices,
and the ``--sketch-func`` ``.cluster`` files byte-equal to the JAX CLI's.
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
