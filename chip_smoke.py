#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rabbittclust_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or block each; any failure raises (non-zero exit):

1. identify the card, the host CPU, and that the shared native library runs
   on this host (rebuilt with g++ if it faults);
2. build kernels K4 / K5b from ``rabbittclust_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain torch version on the card, at the slice's
   shapes (W = 12, K = 1024, rb = 4096) and on small ragged inputs: exactly
   equal, timed with CUDA events;
4. ``clust-mst --fast --device --presketched`` end to end at N = 16,384
   genomes of about 1,000 hashes (64 planted clusters, seed 7), held
   against the native host engine: same partition at 0.05, same MST edge
   count, sorted MST weights equal to 1e-12 relative; both kernels must
   have been launched by that run;
5. a small from-FASTA run (``-l -i list``) against the planted clusters.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a visible GPU it exits 2 and
prints no result.  The full compiler report is kept beside the built
library (``rabbittclust_tpu_torch/build/*.log``).
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_GENOMES, SKETCH, N_CLUSTERS, SEED, THRESHOLD = 16384, 1000, 64, 7, 0.05
KERNEL_SRC = "rabbittclust_tpu_torch/csrc/pair_counts.cu"

NATIVE_PROBE = r"""
import os, sys, tempfile
import numpy as np
from rabbittclust_tpu_torch.host import (
    _decode_packed_mask, compute_mst, load_native, sketch_files_kssd)
assert load_native() is not None, "the native library did not load"
rng = np.random.default_rng(0)
hashes = [np.unique(rng.integers(0, 2**31, 300).astype(np.uint32))
          for _ in range(50)]
compute_mst(hashes, 0.05, 21, with_dense=True)
m = np.packbits(rng.random((128, 128)) < 0.1, axis=1, bitorder="little")
_decode_packed_mask(m, 128, 0, 0, 128, int(np.unpackbits(m).sum()))
with tempfile.TemporaryDirectory(dir=sys.argv[1]) as d:
    files = []
    for g in range(2):
        files.append(os.path.join(d, f"p{g}.fna"))
        with open(files[-1], "w") as f:
            f.write(">p\n" + "".join("ACGT"[x] for x in
                                     rng.integers(0, 4, 20000)) + "\n")
    sketch_files_kssd(files, 1000, 15, 2, 2)
print("native library ok")
"""


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=1, warmup=True):
    """(last result, milliseconds per call) timed with CUDA events."""
    if warmup:
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def make_corpus(n, s, n_clusters, seed, dtype=np.uint32):
    """bench.py::make_sketches's recipe: genome i belongs to planted cluster
    i % n_clusters, keeping each base hash with probability 0.8."""
    rng = np.random.default_rng(seed)
    hi = 2 ** 31 if dtype == np.uint32 else 2 ** 60
    bases = [np.unique(rng.integers(0, hi, size=s).astype(dtype))
             for _ in range(n_clusters)]
    out = []
    for i in range(n):
        b = bases[i % n_clusters]
        keep = b[rng.random(len(b)) < 0.8]
        extra = np.unique(rng.integers(0, hi, size=s - len(keep)).astype(
            dtype))
        out.append(np.unique(np.concatenate([keep, extra])))
    return out


def partition(clusters):
    return sorted(sorted(int(x) for x in c) for c in clusters)


def phase_identify():
    say("== phase 1: identify")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    say(smi.stdout.strip())
    say(f"torch.cuda.get_device_name(0)={torch.cuda.get_device_name(0)} "
        f"device_count={torch.cuda.device_count()} torch={torch.__version__}"
        f" cuda={torch.version.cuda} python={sys.version.split()[0]}")
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            info.setdefault(key.strip(), val.strip())
    cpu = " ".join(f"{k}={info[k]}" for k in (
        "vendor_id", "model name", "cpu family", "model") if k in info)
    say(f"host cpu: {cpu or 'unknown'} (avx512f: "
        f"{'avx512f' in info.get('flags', '').split()}, "
        f"{os.cpu_count()} cores)")
    check_native()


def check_native():
    """The shared native library (committed, built with -march=native) must
    run on this host's CPU; a probe process exercises it and, if it faults,
    the library is rebuilt here with the g++ command of utils/native.py."""
    for attempt in range(2):
        probe = subprocess.run([sys.executable, "-c", NATIVE_PROBE, ROOT],
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
        if probe.returncode == 0:
            say(probe.stdout.strip())
            return
        say(f"native library probe failed (rc {probe.returncode}): "
            f"{probe.stderr.strip()[-400:]}")
        if attempt == 0:  # e.g. SIGILL: built for another CPU; rebuild here
            say("rebuilding native/librtc_native.so with g++ for this host")
            subprocess.run(
                ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                 "-fPIC", "-o", "native/librtc_native.so",
                 "native/rtc_native.cpp", "-lz"],
                cwd=ROOT, check=True, timeout=600)
    raise RuntimeError("the native host library does not run on this host")


def phase_build():
    say("== phase 2: build K4 / K5b (nvcc, sm_90a)")
    from rabbittclust_tpu_torch.kernels import _build
    info = _build.build()
    say(f"build seconds: {info['seconds']:.3f} "
        f"({os.path.relpath(info['path'], ROOT)})")
    name = None
    for line in info["log"].splitlines():
        m = re.search(r"(pair_counts_tiles_kernel|pair_common_kernel)"
                      r"ILi(\d+)ELb(\d)E", line)
        if "Compiling entry" in line and m:
            name = f"{m.group(1)}<W={m.group(2)},two_plane={m.group(3)}>"
        elif name and ("spill" in line or "registers" in line):
            say(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    _build.load_kernels()


def _k4_plain_tile(pl, r0, c0, rb, rows=512):
    """Plain K4 over one tile, in slices of ``rows`` rows."""
    out = torch.empty((rb, rb), dtype=torch.int32, device=pl.plane0.device)
    from rabbittclust_tpu_torch.ops.intersect import pair_counts_plain
    for s in range(0, rb, rows):
        a, b = slice(r0 + s, r0 + s + rows), slice(c0, c0 + rb)
        out[s:s + rows] = pair_counts_plain(
            pl.plane0[a], pl.plane0[b],
            None if pl.plane1 is None else pl.plane1[a],
            None if pl.plane1 is None else pl.plane1[b])
    return out


def phase_kernels(hashes, dev):
    say("== phase 3: kernels against their plain versions on the card")
    from rabbittclust_tpu_torch.host import pack_sketches
    from rabbittclust_tpu_torch.ops import intersect as ix
    from rabbittclust_tpu_torch.ops.pack import planes_to_device
    rec = {"pair_counts_tiles": {"err": 0, "ms": [], "plain_ms": []},
           "pair_common": {"err": 0, "ms": [], "plain_ms": []}}

    def check(name, got, want, what):
        if got.shape != want.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} "
                                 f"!= {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        rec[name]["err"] = max(rec[name]["err"], err)
        if err:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = "
                                 f"{err} (must be 0)")

    rb = 4096
    cases = [("1plane", hashes, 4096, 0),
             ("2plane", make_corpus(rb, SKETCH, N_CLUSTERS, SEED + 1,
                                    np.uint64), 0, 0)]
    for label, hs, r0, c0 in cases:
        use64 = hs[0].dtype == np.uint64
        pk = pack_sketches(hs, use64, pad_n_to=rb)
        pl = planes_to_device(pk, dev)
        got, ms = cuda_ms(lambda: ix.pair_counts_tiles(
            pl.plane0, pl.plane1, [r0], [c0], [1], rb), reps=2)
        want, plain_ms = cuda_ms(lambda: _k4_plain_tile(pl, r0, c0, rb),
                                 warmup=False)
        check("pair_counts_tiles", got[0], want, f"{label} tile")
        rec["pair_counts_tiles"]["ms"].append(ms)
        rec["pair_counts_tiles"]["plain_ms"].append(plain_ms)
        say(f"K4 {label}: N={pk.n} W={pk.width} K={pk.k} rb={rb} tile "
            f"({r0},{c0}): exact; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms; pairs with common>0: {int((want > 0).sum())}")
        rng = np.random.default_rng(1)
        ii = rng.integers(0, len(hs), size=100_000)
        jj = rng.integers(0, len(hs), size=100_000)
        got, ms = cuda_ms(lambda: ix.pair_common(pl.plane0, pl.plane1, ii,
                                                 jj), reps=3)
        it, jt = torch.from_numpy(ii).to(dev), torch.from_numpy(jj).to(dev)
        want, plain_ms = cuda_ms(lambda: ix.pair_common_plain(
            pl.plane0, pl.plane1, it, jt))
        check("pair_common", got, want, label)
        rec["pair_common"]["ms"].append(ms)
        rec["pair_common"]["plain_ms"].append(plain_ms)
        say(f"K5b {label}: 100000 random pairs: exact; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        del pl, got, want
        torch.cuda.empty_cache()

    # small ragged cases: padded tail, an invalid slot, wide buckets
    small = make_corpus(300, 150, 8, SEED)
    for use64 in (False, True):
        hs = [h.astype(np.uint64) * np.uint64(2654435761) for h in small] \
            if use64 else small
        for bits in (None, 3):
            pk = pack_sketches(hs, use64, bucket_bits=bits, pad_n_to=128)
            pl = planes_to_device(pk, dev)
            r0s, c0s, val = [0, 128, 256, 256, 0], [0, 0, 128, 256, 0], \
                [1, 1, 1, 1, 0]
            got = ix.pair_counts_tiles(pl.plane0, pl.plane1, r0s, c0s, val,
                                       128)
            for t in range(4):
                check("pair_counts_tiles", got[t],
                      _k4_plain_tile(pl, r0s[t], c0s[t], 128, rows=128),
                      f"small W={pk.width} tile {t}")
            ii = np.random.default_rng(2).integers(0, 300, size=(2, 5000))
            check("pair_common", ix.pair_common(pl.plane0, pl.plane1, *ii),
                  ix.pair_common_plain(pl.plane0, pl.plane1,
                                       *torch.from_numpy(ii).to(dev)),
                  f"small W={pk.width}")
            say(f"small ragged {'2plane' if use64 else '1plane'} "
                f"W={pk.width} K={pk.k} N=300->{pk.n}: exact")
    if min(ix.LAUNCHES.values()) <= 0:
        raise AssertionError(f"launch counters did not move: {ix.LAUNCHES}")
    return rec


def phase_end_to_end(hashes, dev, tmp):
    say(f"== phase 4: clust-mst --fast --device --presketched, "
        f"N={len(hashes)}")
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.host import (
        KssdParams, SketchSet, clusters_from_forest, compute_mst,
        cut_forest, sketch_io)
    from rabbittclust_tpu_torch.ops import intersect as ix

    p = KssdParams.from_kmer_size(21, 3)
    assert not p.use64
    ss = SketchSet("kssd", p, True, p.use64)
    for i, h in enumerate(hashes):
        ss.append_genome(file_name=f"genome_{i}.fna", name=f"genome_{i}",
                         comment=f"cluster{i % N_CLUSTERS}",
                         seq0_len=3_000_000, total_len=3_000_000,
                         num_seqs=1, hashes=h)
    folder = os.path.join(tmp, "sketches")
    sketch_io.save_kssd_sketches(ss, p, folder)
    out = os.path.join(tmp, "slice.cluster")

    ix.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    rc = main(["--fast", "--device", "--presketched", folder, "-o", out,
               "-d", str(THRESHOLD)], stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ix.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"clust-mst returned {rc}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{launches}")

    t0 = time.perf_counter()
    ref = compute_mst(hashes, THRESHOLD, p.kmer_size)
    host_s = time.perf_counter() - t0
    mst = sketch_io.load_mst(folder)
    n = len(hashes)
    if len(mst[0]) != len(ref.mst[0]):
        raise AssertionError(f"MST edges {len(mst[0])} != host "
                             f"{len(ref.mst[0])}")
    w, w_ref = np.sort(mst[2]), np.sort(ref.mst[2])
    rel = float(np.max(np.abs(w - w_ref) / np.maximum(np.abs(w_ref),
                                                      1e-300))) \
        if len(w) else 0.0
    if rel > 1e-12:
        raise AssertionError(f"sorted MST weights differ: max rel {rel}")
    got = partition(clusters_from_forest(cut_forest(mst, THRESHOLD), n))
    want = partition(clusters_from_forest(cut_forest(ref.mst, THRESHOLD),
                                          n))
    if got != want:
        raise AssertionError("partition at the threshold differs from the "
                             "host engine's")
    planted = partition([list(range(c, n, N_CLUSTERS))
                         for c in range(N_CLUSTERS)])
    if not os.path.getsize(out):
        raise AssertionError("empty cluster file")
    say(f"slice: {len(got)} clusters (planted {N_CLUSTERS}, equal: "
        f"{got == planted}), MST edges {len(mst[0])}, max rel weight diff "
        f"{rel:.3e}: equal to the host engine")
    busy = (stats["sweep_ms"] + stats["pair_common_ms"]) / 1e3
    say("phases (s): " + ", ".join(
        f"{k}={stats[k]:.3f}" for k in (
            "pack_s", "h2d_s", "dispatch_s", "sweep_wait_s", "decode_s",
            "pair_common_s", "edges_s", "kruskal_s", "mst_s",
            "outputs_s")))
    say(f"device (CUDA events): tile sweep {stats['sweep_ms']:.3f} ms, "
        f"pair-common {stats['pair_common_ms']:.3f} ms; busy share of the "
        f"engine wall ~{busy / stats['mst_s']:.3f}")
    say(f"wall {wall:.3f} s (host engine {host_s:.3f} s); "
        f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB); "
        f"tiles {stats['tiles']}, batches {stats['batches']}, candidates "
        f"{stats['candidates']}; launches {launches}")
    return launches


def phase_from_fasta(tmp):
    say("== phase 5: clust-mst --fast --device -l -i list (from FASTA)")
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.host import (
        clusters_from_forest, cut_forest, sketch_io)
    rng = np.random.default_rng(11)
    ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
    work = os.path.join(tmp, "fasta")
    os.makedirs(work)
    files, labels = [], []
    for c in range(8):
        base = rng.integers(0, 4, 100_000)
        for m in range(4):
            seq = base.copy()
            hit = rng.random(len(seq)) < 0.01
            seq[hit] = rng.integers(0, 4, int(hit.sum()))
            files.append(os.path.join(work, f"g{c}_{m}.fna"))
            labels.append(c)
            with open(files[-1], "w") as f:
                f.write(f">genome_{c}_{m} cluster{c}\n")
                f.write(ACGT[seq].tobytes().decode() + "\n")
    lst = os.path.join(work, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(files) + "\n")
    cwd = os.getcwd()
    os.chdir(work)  # the run folder is created in the working directory
    try:
        rc = main(["--fast", "--device", "-l", "-i", lst, "-o",
                   os.path.join(work, "fasta.cluster"), "-d",
                   str(THRESHOLD)])
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"clust-mst returned {rc}")
    runs = [d for d in os.listdir(work)
            if os.path.exists(os.path.join(work, d, "edge.mst"))]
    if len(runs) != 1:
        raise AssertionError(f"expected one run folder, found {runs}")
    mst = sketch_io.load_mst(os.path.join(work, runs[0]))
    got = partition(clusters_from_forest(cut_forest(mst, THRESHOLD),
                                         len(files)))
    want = partition([[i for i, l in enumerate(labels) if l == c]
                      for c in range(8)])
    if got != want:
        raise AssertionError(f"from-FASTA partition {got} != planted")
    say(f"from FASTA: {len(files)} genomes of 100 kb, {len(got)} clusters "
        "= planted")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    import rabbittclust_tpu_torch  # noqa: F401  (fails outside the repo)
    dev = torch.device("cuda", 0)
    phase_identify()
    phase_build()
    hashes = make_corpus(N_GENOMES, SKETCH, N_CLUSTERS, SEED)
    rec = phase_kernels(hashes, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tmp",
                                     dir=ROOT) as tmp:
        launches = phase_end_to_end(hashes, dev, tmp)
        phase_from_fasta(tmp)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    replaces = {"pair_counts_tiles": "rabbittclust_tpu/ops/intersect.py:110",
                "pair_common": "rabbittclust_tpu/ops/engine.py:102"}
    kernels = [{"name": name, "route": "cuda", "source": KERNEL_SRC,
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": rec[name]["err"],
                "ms": rec[name]["ms"][0], "plain_ms": rec[name]["plain_ms"][0]}
               for name in ("pair_counts_tiles", "pair_common")]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
