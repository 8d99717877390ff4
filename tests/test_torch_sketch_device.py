"""The port's device KSSD sketcher (``ops/sketch_device.py``, K7's plain
torch version on the CPU) against the JAX package: the ordered kept
windows of one dispatch window against ``_stream_kernel_fn``, the four
tests of tests/test_sketch_device.py, and the ``RTC_DEVICE_SKETCH=1``
wiring of clust-mst and clust-greedy byte-equal to the JAX CLIs'.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbittclust_tpu.ops.sketch_device import _chunk_kernel, \
    _jitted_stream_kernel
from rabbittclust_tpu.sketch.kssd import \
    kssd_kmer_hashes_numpy as jax_kmer_hashes
from rabbittclust_tpu_torch.ops import sketch_device as sd
from rabbittclust_tpu_torch.sketch.kssd import (
    BASE_MAP,
    KssdParams,
    get_shuffle_table,
    kssd_kmer_hashes_numpy,
    sketch_files_kssd,
)
from tests.test_torch_cli import _run_both
from torch_port_data import dense_keep_table, kssd_window

CPU = torch.device("cpu")


def _rand_seq(rng, n, n_frac=0.05):
    return bytes(
        rng.choice(b"ACGTacgt") if rng.random() > n_frac
        else rng.choice(b"NnRYX-")
        for _ in range(n))


@pytest.mark.parametrize("table_kind", ["shuffle", "dense"])
@pytest.mark.parametrize("k,dr", [(21, 3), (23, 3), (16, 2), (31, 2)])
def test_window_triples_equal_jax(k, dr, table_kind):
    """The plain K7's ordered (hash, position) rows of one window equal the
    first ``total`` (hi << 32 | lo, enc) rows of JAX's
    ``_stream_kernel_fn``, also with rows of another length; at k 31 the
    tuples use all 64 bits.  The plain K7 keeps a window by its
    dimension's bit in the keep bitmap and reads the table for the kept
    ones only."""
    p = KssdParams.from_kmer_size(k, dr)
    k = p.kmer_size
    chunk, s_rows = 8192, 4
    window = kssd_window(k * 7 + dr, k, s_rows * chunk)
    table = get_shuffle_table(p.half_subk) if table_kind == "shuffle" \
        else dense_keep_table(p.dim_end, p.half_subk, k)
    rows = np.lib.stride_tricks.as_strided(
        window, shape=(s_rows, chunk + k - 1), strides=(chunk, 1))
    kern = _jitted_stream_kernel(p, s_rows, chunk + k - 1, chunk)
    fused = np.asarray(kern(jnp.asarray(np.ascontiguousarray(rows)),
                            jnp.asarray(table)))
    total = int(fused[0, 0])
    data = fused[1:1 + total]
    want_h = (data[:, 0].astype(np.uint64) << np.uint64(32)) \
        | data[:, 1].astype(np.uint64)
    want_pos = data[:, 2].astype(np.int64)
    assert total > (1000 if table_kind == "dense" else 0)
    for row in (chunk, 3000):
        h, pos = sd.sketch_window_plain(torch.from_numpy(window),
                                        torch.from_numpy(table), p, row)
        assert h.dtype == torch.int64 and pos.dtype == torch.int32
        assert np.array_equal(h.numpy().view(np.uint64), want_h), row
        assert np.array_equal(pos.numpy(), want_pos), row
    if k == 32:  # a canonical tuple with bit 63 set (hash bit 55)
        assert ((want_h >> np.uint64(55)) & np.uint64(1)).any()


@pytest.mark.parametrize("table_kind", ["shuffle", "dense"])
@pytest.mark.parametrize("k,dr", [(21, 3), (23, 3), (16, 2), (31, 2)])
def test_keep_bitmap_selects_the_dims_jax_keeps(k, dr, table_kind):
    """K7's keep bitmap (plain version): bit d is set exactly where JAX's
    ``_chunk_kernel`` keeps a window of dimension d (``0 <= table[d] <
    dim_end``), position by position over one window, and for every
    dimension of the table; a coarse bit is set exactly where one of its
    256 dimensions is."""
    p = KssdParams.from_kmer_size(k, dr)
    k = p.kmer_size
    n_pos = 1 << 15
    window = kssd_window(k * 5 + dr, k, n_pos)
    table = get_shuffle_table(p.half_subk) if table_kind == "shuffle" \
        else dense_keep_table(p.dim_end, p.half_subk, k)
    _, _, keep = _chunk_kernel(jnp.asarray(window.astype(np.int32)),
                               jnp.asarray(table), p)
    keep = np.asarray(keep)
    bitmap = sd.keep_bitmap_plain(torch.from_numpy(table), p.dim_end)
    n = len(table)
    n_fine = -(-n // 32)
    assert bitmap.dtype == torch.int32
    assert bitmap.numel() == n_fine + -(-n // 8192)
    words = bitmap.numpy().view(np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    fine = bits[:n].astype(bool)
    assert np.array_equal(fine, (table >= 0) & (table < p.dim_end))
    coarse = bits[32 * n_fine:32 * n_fine + -(-n // 256)].astype(bool)
    want = np.pad(fine, (0, -n % 256)).reshape(-1, 256).any(1)
    assert np.array_equal(coarse, want)
    _, dim, valid = sd._row_dims(torch.from_numpy(window).to(torch.int64),
                                 n_pos, p)
    dim, valid = dim.numpy(), valid.numpy()
    assert np.array_equal(keep, valid & fine[np.where(valid, dim, 0)])
    assert keep.sum() > (1000 if table_kind == "dense" else 0)


@pytest.mark.parametrize("k,dr", [(21, 3), (23, 3), (16, 2), (31, 2)])
def test_device_hashes_equal_numpy(k, dr):
    rng = random.Random(42)
    p = KssdParams.from_kmer_size(k, dr)
    table = get_shuffle_table(p.half_subk)
    for n in (10, k, 3000, 10001):
        seq = _rand_seq(rng, n)
        a = np.unique(jax_kmer_hashes(seq, p, table))
        assert np.array_equal(
            a, np.unique(kssd_kmer_hashes_numpy(seq, p, table)))
        b = np.unique(sd.device_kmer_hashes(seq, p, chunk=1024, device=CPU))
        assert np.array_equal(a, b), (k, dr, n)


def test_chunk_boundaries_are_carryover_exact():
    """Every chunk size must give the same hash set (windows spanning the
    chunk boundary come from the k-1 base overlap)."""
    rng = random.Random(7)
    p = KssdParams.from_kmer_size(21, 3)
    seq = _rand_seq(rng, 5000, n_frac=0.02)
    ref = np.unique(sd.device_kmer_hashes(seq, p, chunk=1 << 20,
                                          device=CPU))
    assert np.array_equal(ref, np.unique(jax_kmer_hashes(
        seq, p, get_shuffle_table(p.half_subk))))
    for chunk in (64, 256, 999, 4999, 5000):
        got = np.unique(sd.device_kmer_hashes(seq, p, chunk=chunk,
                                              device=CPU))
        assert np.array_equal(ref, got), chunk


def test_device_sketch_equals_native_sketcher(synthetic_genomes):
    """SketchSet-level: the device sketch of real FASTA files (windows of
    4 rows of 8,192 positions, so files span windows) equals the native
    sketcher, hashes and metadata, 32- and 64-bit."""
    for k, dr in ((19, 2), (23, 3)):
        ss_h, p = sketch_files_kssd(synthetic_genomes.files[:6],
                                    min_len=1000, kmer_size=k, drlevel=dr)
        ss_d, p_d = sd.sketch_files_kssd_device(
            synthetic_genomes.files[:6], min_len=1000, kmer_size=k,
            drlevel=dr, chunk=8192, s_rows=4, device=CPU)
        assert p == p_d
        assert len(ss_h) == len(ss_d)
        for gh, gd in zip(ss_h.hashes, ss_d.hashes):
            assert gh.dtype == gd.dtype
            assert np.array_equal(gh, gd)
        for field in ("file_names", "names", "comments", "seq0_lens",
                      "total_lens", "num_seqs", "param_sizes"):
            assert getattr(ss_h, field) == getattr(ss_d, field), field


def test_multi_record_genomes_dedup_across_records():
    p = KssdParams.from_kmer_size(21, 3)
    rng = random.Random(3)
    r1 = _rand_seq(rng, 2000, n_frac=0.0)
    r2 = r1[:1500] + _rand_seq(rng, 500, n_frac=0.0)  # heavy overlap
    (h,) = sd.sketch_kssd_device([[r1, r2]], p, chunk=512, device=CPU)
    table = get_shuffle_table(p.half_subk)
    expect = np.unique(np.concatenate([
        kssd_kmer_hashes_numpy(r1, p, table),
        kssd_kmer_hashes_numpy(r2, p, table)]))
    assert np.array_equal(h, expect.astype(h.dtype))
    assert h.dtype == np.uint32  # k=21,dr=3: half_k-dr = 8 -> 32-bit


def test_encoding_is_base_map():
    seq = b"ACGTacgtNnRYX-"
    assert sd._encode_codes(seq).tolist() == \
        [0, 1, 2, 3, 0, 1, 2, 3] + [-1] * 6
    assert BASE_MAP.dtype == np.int8


def test_device_sketch_needs_a_card_unless_the_cpu_is_asked(
        synthetic_genomes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        sd.sketch_files_kssd_device(synthetic_genomes.files[:2], 1000, 21, 3)


def _folder_bytes(folder):
    return {p.name: p.read_bytes() for p in sorted(folder.iterdir())}


@pytest.mark.parametrize("module", ["mst", "greedy"])
def test_device_sketch_workflow_equals_jax(module, synthetic_genomes,
                                           tmp_path, monkeypatch):
    """``RTC_DEVICE_SKETCH=1`` with ``--device``: the port's by-file run
    sketches through the device sketcher, and its .cluster file and saved
    folder are byte-equal to the JAX CLI's under the same variable and to
    the port's own native-sketch run."""
    argv = ["--fast", "--device", "-l", "-i", synthetic_genomes.list_file,
            "-d", "0.05", "-m", "1000"]
    monkeypatch.setenv("RTC_DEVICE_SKETCH", "1")
    calls = []
    real = sd.sketch_files_kssd_device

    def spy(*args, **kwargs):
        calls.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(sd, "sketch_files_kssd_device", spy)
    res = _run_both(tmp_path / "dev", monkeypatch, argv,
                    greedy=module == "greedy")
    assert calls == [CPU]
    monkeypatch.delenv("RTC_DEVICE_SKETCH")
    native = _run_both(tmp_path / "native", monkeypatch, argv,
                       greedy=module == "greedy")["port"]
    assert calls == [CPU]
    outs = [res["jax"], res["port"], native]
    for wd, folder in outs[1:]:
        assert (wd / "out.cluster").read_bytes() == \
            (outs[0][0] / "out.cluster").read_bytes()
        assert folder is not None
        assert _folder_bytes(folder) == _folder_bytes(outs[0][1])
