#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rabbittclust_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, one line or block each; any failure raises (non-zero exit):

1. identify the card, the host CPU, and that the shared native library runs
   on this host (rebuilt with g++ if it faults);
2. build kernels K1 / K2 / K3 / K4 (all three modes) / K5b / K7 / K8 and
   the ring step from ``rabbittclust_tpu_torch/csrc`` with nvcc, one
   process per source;
3. each kernel against its plain torch version on the card, at the paths'
   shapes and on small ragged inputs: exactly equal, timed with CUDA
   events, beside the least time the card could take for the same work
   (its bound: bytes over 3.35 TB/s or operations over the peak of their
   type, computed from this run's inputs; NVIDIA publishes no rate for
   the single-bit tensor-core products, so phase 3b measures the card's
   rate of both forms, mma.sync and wgmma, first, and every .b1 bound
   takes the faster).  K4 and K5b read the planes' compact
   form (its build timed on its own line), and their bounds count the
   bytes of that form; K4's operations are the entries its sorted join
   visits and the matches it makes, counted from this run's inputs, at
   the INT32 rate (the nested loop's compares beside them).  K4 at
   W = 12, K = 1024, rb = 4096, 1 and 2 planes: counts and the mask
   mode (with start_index and a ragged n cutting the tile), and beside
   them the library call, one ``torch.sparse.mm`` of the two sides' CSR
   0/1 incidences (genomes x distinct hashes); K5b over 10^5
   random pairs; K1 at rb = 4096 and 8192 bits (diagonal, off-diagonal and
   padded tiles, an invalid slot; small cases of its three bounds and both
   distances, ragged rb of 96 and 160 and 64 to 8192 bits; rb = 8192),
   beside the shared-bit product alone in float32 and in bfloat16; K2, full and
   compact, over K1's masks: panel 0 of the N = 131,072 sweep (512 tiles,
   span n_pad, cap 65,536) and the whole sweep at rb = 8192 (136 tiles),
   each under mixed, all-distinct (round 1) and planted (round 2) labels,
   panel 1 (16 tiles) under mixed labels, at N = 16,384 with a clear list
   of repeated targets at rb = 4096 and 8192, and its compaction alone at
   n_pad 131,072 and 1,048,576;
4. ``clust-mst --fast --device --presketched`` end to end at N = 16,384
   genomes of about 1,000 hashes (64 planted clusters, seed 7), held
   against the native host engine: same partition at 0.05, same MST edge
   count, sorted MST weights equal to 1e-12 relative; K4's mask mode and
   K5b must have been launched by that run, K4's counts mode (the only
   allocation of (batch, rb, rb) counts) never;
5. a small from-FASTA run (``-l -i list``) against the planted clusters;
6. the MST-free main path at full width: ``clust-mst --fast --device
   --presketched -e`` at N = 131,072 (bench.py's recipe; the dispatcher
   takes the label-propagation engine, 528 tiles in panels of 512 + 16):
   the partition must be the 64 planted clusters and K1 and K2 must have
   been launched by that run;
7. both MST-free engines forced (stream, then label propagation) at
   N = 16,384 against phase 4's host partition, and the ``-t 1``
   exact-order arm at N = 2,000 against the native serial engine's member
   order;
8. ``clust-greedy --fast --device --presketched`` at N = 32,768: (a) a
   sparse corpus (16,384 planted pairs), where the ``auto`` route must pick
   the device sweep, and (b) the first 32,768 genomes of phase 6's corpus
   (64 clusters) under ``RTC_GREEDY_DEVICE=force``; K1 launched under its
   greedy bound, clusters, representatives and the ``.cluster`` file equal
   to the native greedy's on the same KSSD greedy order; device route
   (sweep and host replay apart) and native walls, the density probe's
   degree;
9. MinHash at N = 16,384 sketches of 1,000 64-bit hashes (64 clusters):
   (a) ``clust-greedy --device --presketched`` (K1 under its minhash bound)
   equal to the native parity engine, (b) ``clust-mst --device
   --presketched`` (K4's mask mode and K5b on two planes) held to the
   native host MST as phase 4 is;
10. ``clust-mst --fast --device --presketched --append`` of 1,024 FASTA
   genomes onto phase 4's folder: K4's mask mode launched with start_index
   16,384, the new folder's MST held to the native ``compute_mst`` with
   the same start_index and saved edges, the source folder unchanged;
11. ``clust-dbscan --fast --device --presketched`` on phase 8a's sparse
   corpus and on the first 16,384 genomes of phase 6's, each under
   ``RTC_PULL_MODE=mask`` and ``idx``: the ``.cluster`` file byte-equal to
   the host path's (native pairs), K3 launched exactly on the idx runs;
12. ``clust-leiden --fast --device --presketched`` on the dense N = 16,384
   corpus: ``RTC_LEIDEN_DEVICE=force`` under mask and idx, then the default
   (native) route; the three ``.cluster`` and ``leiden.graph`` files
   byte-equal, and the graph build's force-vs-native times;
13. the device KSSD sketcher (K7) on its path: ``clust-mst --fast
   --device -l -i list`` over 128 FASTA genomes of 4 Mb (32 ancestors x 4
   copies at 1 % point mutations) with ``RTC_DEVICE_SKETCH=1`` and without
   it: the ``.cluster`` files and the saved folders byte-equal, the
   partition the 32 planted groups, K7 launched on the device run only;
   then ``clust-greedy`` the same way, and the first 16 genomes at k 21,
   drlevel 2 (64-bit hashes); each run's sketch-phase seconds;
14. the WMH / OMH / HLL arm (K8): ``clust-mst --sketch-func WMH``, ``OMH``
   and ``HLL`` on 128 genomes of 20 kb (32 ancestors x 4 copies at 0.5 %
   point mutations, the rate of tests/test_extra_sketches.py): the distance
   matrix equal to the plain version's on the card, the partition the
   planted one, K8 launched on WMH and OMH and not on HLL; the seconds of
   sketching, pairs and Kruskal;
15. the mesh ring engines (``parallel/dist_engine.py``) over logical
   shards on the one card (a mesh that repeats ``cuda:0``; shards run one
   after another, so no multi-GPU time is claimed): (a) ``RTC_MESH=1
   clust-mst --fast --device --presketched`` at N = 16,384, a 1-shard exact
   ring, ``edge.mst`` and ``.cluster`` byte-equal to phase 4's dense-engine
   run; (b) ``distributed_mst`` exact and bitmap over 4 shards: the exact
   ring's MST equal to phase 4's ``edge.mst``, both partitions at 0.05
   phase 4's; (c) the mesh LP engine over 8 shards at N = 131,072: the 64
   planted clusters, its rounds and their device milliseconds; (d)
   ``distributed_threshold_clusters`` and ``distributed_similarity_graph``
   over 4 shards: phase 4's partition, and the edges and weights of the
   port's ``build_similarity_graph`` (no kNN);
16. ``greedy_cluster_device(conflict="batched", batch_size=2048)`` (K6) at
   N = 32,768 on phases 8a's and 8b's corpora, equal to the copied
   ``greedy_cluster_batched`` (which runs in two worker processes at the
   lowest priority while the card runs phase 3); the device sweep and host
   seconds;
17. the multi-process mesh (``parallel/multihost.py``) with two ranks that
   share cuda:0, so the ring's hop goes through pinned host memory over
   gloo: (a) two ``chip_smoke.py --mesh-child`` processes of 2 shards
   each over phase 4's corpus, each passing its ``shard_bounds`` block:
   the threshold clusters phase 4's host partition, the MST cut the native
   host MST's edge for edge (weights to 1e-12 relative) and the dense
   engine's byte for byte; per process the K9b steps, the bytes and
   milliseconds of each hop, the transport and the wall; (b) ``clust-mst``
   and ``clust-greedy --multihost`` with 2 processes (``parallel/
   launch.py``) over phase 13's list, each ``.cluster`` byte-equal to the
   single-process ``--device -t 2`` run; (c) ``dryrun_multichip(4)`` over
   ``[cuda:0] * 4`` (the stats ring, then its own 2-process simulation);
18. the state files and RepDB: (a) ``clust-greedy --fast --device --db
   --build --presketched`` over phase 8a's folder (N = 32,768 sparse, ~16,384
   representatives), then ``batch_query_device`` on the card (K1, and K3
   under ``RTC_PULL_MODE=idx``) for 4,096 queries (3,072 from
   representatives at keep 0.8, 1,024 novel; seed 7), its hits and the
   assignment from its best hit equal to the serial ``query_topk`` and
   ``assign`` loops, with the probe's wall, K1's launches, tiles and
   kernel milliseconds and the host re-scoring seconds; (b) the RepDB
   CLIs over phase 13's genomes (copies 0-1 built, 2-3 queried):
   ``--query --device`` (K1 launched) byte-equal to ``--query`` (none),
   ``--assign``, ``--stats`` and ``--append``, and the MST RepDB built on
   the dense engine (K4's mask mode, K5b) equal to the host-built one;
   (c) ``--save-rep`` then ``--append`` of copies 2-3 for clust-mst
   ``--fast``, clust-greedy ``--fast``, MinHash clust-mst and MinHash
   clust-greedy: each partition the 32 planted groups (the greedy pass's
   left-out representatives put back), the MinHash classic append's K4
   mask mode from start_index 64 on two planes and its MST held to the
   native ``compute_mst`` as phase 10's is, the source folders unchanged
   but for the KSSD MST state saved again; (d) ``--db --query/--assign
   --multihost`` with two ranks on cuda:0 byte-equal to (b)'s TSVs;
19. the profiler hook, the ``-t 1`` arms and the malloc tuning: (a) under
   ``RTC_PROFILE_DIR`` phase 6's ``-e`` run at N = 131,072 (LP), the
   stream engine forced at N = 16,384 and a dense-engine ``-e`` run
   (``RTC_MST_CLUSTERS_FAST=0``) at N = 2,048, each writing one JSON trace
   in its phase's directory (``labelprop_cluster`` holding K1's and K2's
   kernels, ``bitmap_filter_cluster`` K1's, ``dense_mst_device_compact``
   K4's and K5b's, found by name), then the same run untraced, which must
   make nothing: the traces' sizes and device events, both walls; all in
   a process of its own, as a CLI run is (``chip_smoke.py --trace-child
   TMP``: on the card's machine a profiler session that starts long after
   its process's first loses the card's records); (b)
   ``clust-mst --fast -l --device -e -t 1`` at 2048 bits on 400 genomes
   (rb 256: the varied corpus at the tuned k and at ``-k 21``, the tie
   corpus at ``-k 21``) and 5,000 genomes (rb 512), the corpora of
   tests/test_torch_scale*.py's parameters drawn with numpy: K1 launched,
   the ``.cluster`` byte-equal to the port's CPU run's; (c) ``import
   rabbittclust_tpu_torch`` in a child process makes glibc's two
   ``mallopt`` calls, and none under ``RTC_MALLOC_REUSE=0``.

Phase 3d holds K3 (``compact_masks``, ``compact_steps``, and K1 + K3 as
``batched_filter``) to its plain versions on batches of 16 tiles at rb
1024 and 4096 over the planted and the sparse corpus, one all-ones 4096^2
tile and one slab of 5 steps of 16384^2 (the bitmap ring's close at
N = 131,072), checks that it is one kernel launch a call, and times it
(kernel, call, and the non-syncing ``compact_masks_into``) beside one
``torch.nonzero``; phase 7 also runs the stream engine under
``RTC_PULL_MODE=idx``.  Phase 3e
holds K7 (``sketch_window``) to its plain version over one full dispatch
window (16 x 2^20 positions) at k 21 / dr 3, k 23 / dr 3 and k 31 / dr 2,
and a low-complexity window over a table that keeps every dimension, and
each table's keep bitmap (K7's first kernel) to its plain version, with
each window's kernels apart;
phase 3f holds K8 (``tuple_matches``, in its packed and its int32 form)
and its id pass alone (``tuple_ids``) to their plain versions at N = 8,192
at the WMH (50 x 4 words) and OMH (64 x 6) shapes.  Phase 3g holds K6
(``greedy_filter``) to its plain version at B = 2,048 against R = 1,024
and 16,384 reps, triangular, and a ragged B = 7, over phases 8a's and 8b's
resident signatures, beside a bfloat16 ``torch.mm`` of the gathered
product; phase 3h
holds each step kind of the exact, bitmap and mask rings (self, interior,
antipodal, and the antipodal step's empty tile) to the plain steps at 4
shards of N = 16,384 and 8 shards of N = 131,072 (the slab step also over
64-bit hashes and over 256-bit signatures at the first shape), times the
whole bitmap ring at both shapes, and one LP round over a shard's slab
with a clear list of repeated targets.  Phases 3f, 3g and 3h give each
case's kernel time
(``device_ms``: the durations of its kernels and memsets from
``torch.profiler`` over 20 calls, the copies apart) and its call's time
(CUDA events), and the same two times of the ``torch.mm``.
``python3 chip_smoke.py --parent DIR`` (DIR holding the parent
commit's ``rabbittclust_tpu_torch/``) also builds that package from its
own sources and times its compact form's build and its K4 in the counts
and mask modes (phase 3), its K2 over panels 0 and 1 (phase 3c), its K3
(phase 3d, its count pull in its call),
its K7 windows, its K8, its K6, its slab step (alone and with its close),
its ring, its exact ring's steps, its LP slab round and its stats ring's
steps and band (phase 3i) in turns with this tree's, equal outputs
required.  Phases 3h and 15 print the bitmap ring's closes by part
(counts pull, K3, positions copy, host decode).
Phase 3h's exact ring packs the shards its cases read (their compact
forms' build timed, all four at N = 16,384, three of the eight at
N = 131,072) and times each step kind's kernels and call
(``device_ms``), with the library call at the interior 4096^2 step (the
kernels line's case).
Phase 3i holds K4's stats mode (``pair_stats_tiles``, the stats ring's
step) to the plain step on a band of 256 rows for each step kind at 4
shards of N = 16,384, and times the whole steps and the band beside their
bounds and K4's counts mode: the count equal, the float32 minimum within
4 ulp; the library call on the interior step's band (the kernels line's
case).  Each library call's line gives its ratio to the kernel's time on
the same rows and columns.

Each of phases 8-12, 15-18 and 19a prints its kernels' launch counts on a
line of its own.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a visible GPU it exits 2 and
prints no result.  The full compiler report is kept beside the built
library (``rabbittclust_tpu_torch/build/*.log``).
"""

import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_GENOMES, SKETCH, N_CLUSTERS, SEED, THRESHOLD = 16384, 1000, 64, 7, 0.05
N_SLICE, BITS, RB = 131072, 8192, 4096
N_GREEDY = 32768  # the greedy phases' corpora (8a, 8b)
# published peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
HBM_BPS = 3.35e12       # device memory, bytes/s
INT8_TC_OPS = 1979e12   # int8 tensor-core operations/s
CORE_OPS = 67e12        # operations/s outside the tensor cores (float32;
#                         an int32 compare is issued at most at this rate)
# INT32 operations/s: 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock
# (CORE_OPS is 132 x 128 float32 lanes x 2, a multiply-add, x that clock)
INT32_OPS = 132 * 64 * 1.98e9
# name: (source, the JAX function it replaces)
KERNELS = {
    "pair_counts_tiles": ("rabbittclust_tpu_torch/csrc/pair_counts.cu",
                          "rabbittclust_tpu/ops/intersect.py:110"),
    "pair_mask_tiles": ("rabbittclust_tpu_torch/csrc/pair_counts.cu",
                        "rabbittclust_tpu/ops/engine.py:52"),
    "pair_common": ("rabbittclust_tpu_torch/csrc/pair_counts.cu",
                    "rabbittclust_tpu/ops/engine.py:102"),
    "filter_mask": ("rabbittclust_tpu_torch/csrc/filter_mask.cu",
                    "rabbittclust_tpu/ops/bitmap.py:345"),
    "labelprop_round": ("rabbittclust_tpu_torch/csrc/labelprop_round.cu",
                        "rabbittclust_tpu/ops/labelprop.py:101"),
    "mask_compact": ("rabbittclust_tpu_torch/csrc/mask_compact.cu",
                     "rabbittclust_tpu/ops/bitmap.py:389"),
    "kssd_sketch": ("rabbittclust_tpu_torch/csrc/kssd_sketch.cu",
                    "rabbittclust_tpu/ops/sketch_device.py:164"),
    # K7's keep set as a bitmap, built once a table (the keep test of
    # _chunk_kernel)
    "kssd_keep_bitmap": ("rabbittclust_tpu_torch/csrc/kssd_sketch.cu",
                         "rabbittclust_tpu/ops/sketch_device.py:116"),
    "tuple_match": ("rabbittclust_tpu_torch/csrc/tuple_match.cu",
                    "rabbittclust_tpu/ops/extra_pairs.py:48"),
    # K8's id pass: the C-word equality of _jitted_match as each sample's
    # class ids (launched by K8's C entry, and alone by tuple_ids)
    "tuple_ids": ("rabbittclust_tpu_torch/csrc/tuple_match.cu",
                  "rabbittclust_tpu/ops/extra_pairs.py:53"),
    # K1's gathered form, then K3's row form
    "greedy_filter": ("rabbittclust_tpu_torch/csrc/filter_mask.cu",
                      "rabbittclust_tpu/ops/greedy_device.py:310"),
    # K4's mask mode over two shards, K3, K5b
    "ring_edges": ("rabbittclust_tpu_torch/csrc/pair_counts.cu",
                   "rabbittclust_tpu/parallel/dist_engine.py:168"),
    # K1 over two shards into the slab a step (its launches: the steps);
    # the ring's close, K3 once a shard, is timed as its close_ms
    "ring_bitmap": ("rabbittclust_tpu_torch/csrc/ring_step.cu",
                    "rabbittclust_tpu/parallel/dist_engine.py:296"),
    "ring_masks": ("rabbittclust_tpu_torch/csrc/ring_step.cu",
                   "rabbittclust_tpu/parallel/dist_engine.py:620"),
    # K2 over each shard's slab
    "dist_lp_round": ("rabbittclust_tpu_torch/csrc/labelprop_round.cu",
                      "rabbittclust_tpu/parallel/dist_engine.py:671"),
    # K4's stats mode over two shards (the dry run's stats ring)
    "ring_stats": ("rabbittclust_tpu_torch/csrc/pair_counts.cu",
                   "rabbittclust_tpu/parallel/dist_engine.py:78"),
}

NATIVE_PROBE = r"""
import os, sys, tempfile
import numpy as np
from rabbittclust_tpu_torch.cluster.mst import compute_mst
from rabbittclust_tpu_torch.ops.bitmap import _decode_packed_mask
from rabbittclust_tpu_torch.sketch.kssd import sketch_files_kssd
from rabbittclust_tpu_torch.utils.native import load_native
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


T_START = time.perf_counter()


def say(msg):
    """Print a line; a phase's heading also gets the script's seconds."""
    if msg.startswith("== phase"):
        msg += f" [{time.perf_counter() - T_START:.1f} s]"
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


# which timer gave each device time of device_ms: the profiler's device
# activity, or CUDA events where the profiler showed none
DEVICE_TIMER = {"profiler": 0, "events": 0}


def device_ms(fn, reps=20):
    """(last result, kernel ms, call ms, parts) per call of ``fn``: the
    kernel time is the sum of the durations of the kernels and memsets in
    ``torch.profiler``'s ``key_averages()`` over ``reps`` calls (a memset
    and a fill kernel do the same work, so both count); the call's time is
    CUDA events around as many calls; ``parts`` the ms a call of each
    kernel (short name), of the memsets and of the copies.  Where the
    profiler shows no device activity, the events' time stands for the
    kernels' (``DEVICE_TIMER`` counts which)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()  # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
        key = ("copies" if e.key.startswith("Memcpy") else
               "memsets" if e.key.startswith("Memset") else
               re.sub(r"^.*?(\w+(<[^()]*>)?)\(.*$", r"\1", e.key))
        parts[key] = parts.get(key, 0.0) + us / 1e3 / reps
    kern = sum(v for k, v in parts.items() if k != "copies")
    out, call = cuda_ms(fn, reps=reps, warmup=False)
    if parts:
        DEVICE_TIMER["profiler"] += 1
        return out, kern, call, parts
    DEVICE_TIMER["events"] += 1
    return out, call, call, parts


def fmt_parts(parts):
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(
        parts.items(), key=lambda kv: -kv[1]))


# the parent commit's port package when the script runs with --parent DIR
# (DIR/rabbittclust_tpu_torch, imported as rtc_parent): phases 3, 3c, 3d,
# 3e, 3f, 3g, 3h and 3i then time its compact form's build and K4 (counts
# and mask modes), its K2 panel round, its K3, its K7, its K8, its K6, its
# ring steps (the slab step and the exact ring's), its LP slab round and
# its stats ring's steps in the same call
PARENT = {}


def load_parent(root):
    """Import ``root/rabbittclust_tpu_torch`` as ``rtc_parent`` and build
    its kernels from its own sources (into its own build directory)."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "rabbittclust_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "rtc_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["rtc_parent"] = mod
    spec.loader.exec_module(mod)
    built = importlib.import_module("rtc_parent.kernels._build").build()
    PARENT.update(
        ix=importlib.import_module("rtc_parent.ops.intersect"),
        pack=importlib.import_module("rtc_parent.ops.pack"),
        bm=importlib.import_module("rtc_parent.ops.bitmap"),
        gd=importlib.import_module("rtc_parent.ops.greedy_device"),
        de=importlib.import_module("rtc_parent.parallel.dist_engine"),
        sd=importlib.import_module("rtc_parent.ops.sketch_device"),
        xp=importlib.import_module("rtc_parent.ops.extra_pairs"),
        lp=importlib.import_module("rtc_parent.ops.labelprop"))
    say(f"the parent's port package from {pkg}: its kernels built in "
        f"{built['seconds']:.1f} s")


def ab_times(change, parent=None, reps=20):
    """``device_ms`` of ``change`` and, when given, of ``parent``, in turns
    parent, change, change, parent: {who: (last result, [kernel ms], [call
    ms], parts of the last)}."""
    order = ["change"] if parent is None else ["parent", "change", "change",
                                                "parent"]
    fns = {"change": change, "parent": parent}
    res = {}
    for who in order:
        out, dev, call, parts = device_ms(fns[who], reps)
        r = res.setdefault(who, [None, [], [], None])
        r[0] = out
        r[1].append(dev)
        r[2].append(call)
        r[3] = parts
    return res


def fmt_ms(xs):
    return " / ".join(f"{x:.4f}" for x in xs)


def same_output(a, b):
    """Tensors, arrays, or tuples of them, equal throughout."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(same_output, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return torch.equal(a, b)


def parent_turns(ab, what, want, pick=lambda out: out):
    """The parent's part of a line (empty without --parent) from
    ``ab_times``' result: its kernel and call ms in turns with this
    tree's, and this tree's kernel time as a share of it (the faster turn
    of each); its output (``pick`` of it) must equal ``want``."""
    if "parent" not in ab:
        return ""
    if not same_output(pick(ab["parent"][0]), want):
        raise AssertionError(f"the parent's {what} differ from this tree's")
    return (f"; the parent's kernels {fmt_ms(ab['parent'][1])} ms ("
            f"{fmt_parts(ab['parent'][3])}), call "
            f"{fmt_ms(ab['parent'][2])} ms (in turns parent, this, this, "
            f"parent; {what} equal), this at "
            f"{min(ab['change'][1]) / min(ab['parent'][1]):.3f} of it")


def build_turns(plane_sets):
    """The compact forms' build (``compact_planes`` of each (plane0,
    plane1) of ``plane_sets``, host clock to a synchronise), twice, in
    turns with the parent's build of its own forms under --parent: a
    line's text, with the ms a form."""
    from rabbittclust_tpu_torch.ops import pack
    ppack = PARENT.get("pack")
    order = ([("the parent's", ppack), ("this", pack), ("this", pack),
              ("the parent's", ppack)] if ppack else [("this", pack)] * 2)
    ms = {}
    for who, mod in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p0, p1 in plane_sets:
            mod.compact_planes(p0, p1)
        torch.cuda.synchronize()
        ms.setdefault(who, []).append(1e3 * (time.perf_counter() - t0))
    k = len(plane_sets)
    return "builds again in turns: " + "; ".join(
        f"{who} {fmt_ms(v)} ms ({fmt_ms([x / k for x in v])} ms a form)"
        for who, v in ms.items())


def library_call(rec, kernels, rows, cols, check, what):
    """Time ``incidence_product`` of ``rows`` and ``cols`` (each (form,
    first genome, genomes)) (kernels and call, ``device_ms``) as the
    ``library_ms`` of the records ``kernels`` names, after ``check`` (a
    function of its dense counts) has held it to the kernel's counts; each
    record's kernel time (``kernels[name]``) is from the same rows and
    columns, and the line gives its ratio to the library call's.  Where
    PyTorch refuses the product, ``library_note`` says so."""
    for name in kernels:
        rec.setdefault(name, {"err": 0, "ms": [], "plain_ms": [],
                              "bound": []})
    call, dense, why = incidence_product(rows, cols)
    if call is None:
        for name in kernels:
            rec[name].setdefault("library_note", f"refused: {why}")
        say(f"{what}: the library call, torch.sparse.mm of two CSR "
            f"incidences, refused on the card: {why}")
        return
    if not check(dense):
        raise AssertionError(f"{what}: the library call's counts differ "
                             "from the kernel's")
    _, l_dev, l_call, parts = ab_times(call, reps=5)["change"]
    for name in kernels:
        rec[name].setdefault("library_ms", l_dev[0])
        rec[name].setdefault("library_call_ms", l_call[0])
    say(f"{what}: the library call, torch.sparse.mm of the two sides' CSR "
        f"0/1 incidences (genomes x distinct hashes, float32): counts equal "
        f"to the kernel's; kernels {fmt_ms(l_dev)} ms ({fmt_parts(parts)}),"
        f" call {fmt_ms(l_call)} ms; on the same rows and columns " +
        ", ".join(f"{name}'s kernels {ms:.4f} ms, library / kernel "
                  f"{l_dev[0] / ms:.3f}" for name, ms in kernels.items()))


def fmt_close(record):
    """The bitmap ring's closes by part, ms a shard (``ring_positions``'s
    record): the host's wait for the counts (K3 runs ahead of them), K3
    and the positions copy (CUDA events), the host decode, and the whole
    close up to the positions on the host."""
    return "; ".join(
        f"{label} {[round(x, 4) for x in record.get(key, [])]}"
        for label, key in (("counts pull", "counts_ms"), ("K3", "k3_ms"),
                           ("positions copy", "copy_ms"),
                           ("host decode", "decode_ms"),
                           ("close to the host", "compact_ms"))) + " ms"


@contextlib.contextmanager
def recorded_closes(de):
    """While the block runs, each bitmap ring's close on a shard
    (``de.ring_positions``) appends its parts to the dict it yields (for
    ``fmt_close``)."""
    rec = {"compact_ms": []}
    inner = de.ring_positions

    def close(slab, counts, los, record=None):
        return inner(slab, counts, los, rec)

    de.ring_positions = close
    try:
        yield rec
    finally:
        de.ring_positions = inner


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
    card = smi.stdout.strip()
    say(card)
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
    return card


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
    say("== phase 2: build K1 (with K6's gathered form) / K2 / K3 / K4 / K5b"
        " / K7 / K8 / the ring step (nvcc, sm_90a)")
    from rabbittclust_tpu_torch.kernels import _build
    info = _build.build()  # all nvcc processes at once
    say(f"build seconds: {info['seconds']:.3f} "
        f"({os.path.relpath(info['path'], ROOT)})")
    name = None
    for line in info["log"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("spill" in line or "registers" in line):
            say(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    _build.load_kernels()


def bound(n_bytes, n_ops, ops_rate):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``n_bytes`` and do ``n_ops`` operations at ``ops_rate``."""
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / ops_rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def occupancy(pl):
    """(G, K) int64: the non-pad slots of each (genome, bucket); a pad has
    the top bit set (in plane1 for 64-bit hashes, ``ops/pack.py``)."""
    top = pl.plane0 if pl.plane1 is None else pl.plane1
    return (top >= 0).sum(1, dtype=torch.int64)


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


def live_blocks(i0, j0, tri, start_index=0, n=None):
    """(rows, cols) bool over the GROUP x GROUP blocks with row origins
    ``i0`` and column origins ``j0`` (1-D int64 tensors): those K4's mask
    and stats modes compute (some pair j < i with ``tri``; some row in
    [start_index, n) when ``n`` is given).  The counts mode computes all."""
    from rabbittclust_tpu_torch.ops.pack import GROUP
    live = torch.ones((len(i0), len(j0)), dtype=torch.bool, device=i0.device)
    if tri:
        live &= j0[None, :] < i0[:, None] + GROUP - 1
    if n is not None:
        live &= ((i0 + GROUP > start_index) & (i0 < n))[:, None]
    return live


def origins(lo, count):
    """The block origins lo, lo + GROUP, ... of ``count`` rows."""
    from rabbittclust_tpu_torch.ops.pack import GROUP
    return lo + GROUP * torch.arange(count // GROUP, device="cuda")


def block_compares(occ, r0, nr, c0, nc, live=None):
    """The nested loop's work, K4's join before its segments were sorted:
    for every block of GROUP x GROUP pairs of rows [r0, r0 + nr) against
    columns [c0, c0 + nc), its rows' real entries of each bucket against
    its columns' (sum_k R_k C_k), over the blocks ``live`` (all by
    default).  ``occ`` (G, K) holds the entries of each (genome, bucket),
    or is ``(occ_rows, occ_cols)`` where the columns are another form's."""
    from rabbittclust_tpu_torch.ops.pack import GROUP
    o_r, o_c = occ if isinstance(occ, tuple) else (occ, occ)
    k = o_r.shape[1]
    rows = o_r[r0:r0 + nr].view(-1, GROUP, k).sum(1).double()
    cols = o_c[c0:c0 + nc].view(-1, GROUP, k).sum(1).double()
    need = rows @ cols.T  # exact: sums below 2^53
    if live is not None:
        need = need * live
    return int(need.sum())


def entry_ids(key, bucket):
    """int64 ids of entries, equal where both the bucket and the value
    (``sort_key``) are: a stored value is a hash's bits below its
    bucket's, so values of two buckets may be equal."""
    _, rank = torch.unique(key, return_inverse=True)
    return bucket * (int(rank.max()) + 1 if len(rank) else 1) + rank


def group_keys(cf, g0, g1):
    """The grouped entries of genomes [g0, g1) (whole groups) of form
    ``cf``: their keys (``sort_key``), the bucket and the group (from 0)
    of each, and the entries of each group."""
    from rabbittclust_tpu_torch.ops.pack import GROUP, sort_key
    lo, hi = int(cf.start[g0]), int(cf.start[g1])
    key = sort_key(cf.g0[lo:hi], None if cf.g1 is None else cf.g1[lo:hi])
    seg = cf.goff[g0 // GROUP:g1 // GROUP].long().diff(dim=1)
    k = seg.shape[1]
    bucket = torch.repeat_interleave(
        torch.arange(k, device=key.device).repeat(len(seg)), seg.flatten())
    per = cf.start[g0:g1 + 1:GROUP].diff()
    return key, bucket, torch.repeat_interleave(
        torch.arange(len(per), device=key.device), per), per


def join_work(rf, r0, nr, cf, c0, nc, live=None, chunk=1 << 20):
    """(entries visited, matches) of K4's sorted join over the GROUP x
    GROUP blocks of rows [r0, r0 + nr) of form ``rf`` against columns
    [c0, c0 + nc) of form ``cf``, over the blocks ``live`` (all by
    default): a block reads its row group's and its column group's
    entries once and steps once a match.  A block's matches are the sum,
    over its values, of the row genomes holding the value times the
    column genomes holding it: a float64 product (exact) of the two
    sides' group-by-value incidences, ``chunk`` values at a time."""
    kr, br, gr, er = group_keys(rf, r0, r0 + nr)
    kc, bc, gc, ec = group_keys(cf, c0, c0 + nc)
    _, inv = torch.unique(entry_ids(torch.cat([kr, kc]),
                                    torch.cat([br, bc])),
                          return_inverse=True)
    sides = ((inv[:len(kr)], gr, len(er)), (inv[len(kr):], gc, len(ec)))
    d = int(inv.max()) + 1 if len(inv) else 0
    m = torch.zeros((len(er), len(ec)), dtype=torch.float64,
                    device=kr.device)
    for lo in range(0, d, chunk):
        inc = []
        for ids, grp, n_g in sides:
            sel = (ids >= lo) & (ids < lo + chunk)
            a = torch.zeros((n_g, chunk), dtype=torch.float64,
                            device=kr.device)
            a.index_put_((grp[sel], ids[sel] - lo), torch.ones(
                int(sel.sum()), dtype=torch.float64, device=kr.device),
                accumulate=True)
            inc.append(a)
        m += inc[0] @ inc[1].T
        del inc
    if live is None:
        live = torch.ones_like(m, dtype=torch.bool)
    visits = ((er[:, None] + ec[None, :]).double() * live).sum()
    return int(visits), int((m * live).sum())


def join_bound(n_bytes, work):
    """K4's bound: ``n_bytes`` (each compact form read once, the output
    written once) over the memory rate, or the entries visited plus the
    matches (``work``, from ``join_work``) at the INT32 rate."""
    return bound(n_bytes, sum(work), INT32_OPS)


def incidence_product(rows, cols):
    """The library call beside K4 (the port never calls it): one
    ``torch.sparse.mm`` of the two sides' CSR 0/1 incidence matrices,
    genomes x distinct hashes in float32 (exact below 2^24), ``rows``
    against ``cols``, each (compact form, first genome, genomes); the hash
    ids from ``torch.unique(..., return_inverse=True)`` over the
    genome-major values, outside the call.  Returns (the call, its first
    result as a dense (rows, cols) int32 tensor, None), or (None, None,
    why) when PyTorch refuses the product here."""
    from rabbittclust_tpu_torch.ops.pack import sort_key
    keys, buckets, genomes = [], [], []
    for f, g0, m in (rows, cols):
        lo, hi = int(f.start[g0]), int(f.start[g0 + m])
        keys.append(sort_key(f.v0[lo:hi], None if f.v1 is None else
                             f.v1[lo:hi]))
        occ = f.occ[g0:g0 + m].long()
        buckets.append(torch.repeat_interleave(torch.arange(
            occ.shape[1], device=occ.device).repeat(m), occ.flatten()))
        genomes.append(torch.repeat_interleave(
            torch.arange(m, device=occ.device), occ.sum(1)))
    _, inv = torch.unique(entry_ids(torch.cat(keys), torch.cat(buckets)),
                          return_inverse=True)
    d = int(inv.max()) + 1
    ids = (inv[:len(keys[0])], inv[len(keys[0]):])
    ones = [torch.ones(len(k_), dtype=torch.float32, device=k_.device)
            for k_ in keys]
    try:
        a = torch.sparse_coo_tensor(torch.stack([genomes[0], ids[0]]),
                                    ones[0], (rows[2], d)).coalesce()
        bt = torch.sparse_coo_tensor(torch.stack([ids[1], genomes[1]]),
                                     ones[1], (d, cols[2])).coalesce()
        a, bt = a.to_sparse_csr(), bt.to_sparse_csr()

        def call():
            return torch.sparse.mm(a, bt)

        out = call().to_dense().to(torch.int32)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, None, f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return call, out, None


def compact_bytes(cf, g0, g1, planes):
    """Bytes of the compact form K4 reads for genomes [g0, g1): their
    grouped entries (values and ids) and their groups' bucket offsets."""
    from rabbittclust_tpu_torch.ops.pack import GROUP
    entries = int(cf.start[g1] - cf.start[g0])
    return entries * (4 * planes + 1) + (g1 - g0) // GROUP * \
        cf.goff.shape[1] * 4


def phase_kernels(hashes, dev):
    say("== phase 3: kernels against their plain versions on the card")
    from rabbittclust_tpu_torch.distance.mash import size_ratio_limit
    from rabbittclust_tpu_torch.ops.pack import pack_sketches
    from rabbittclust_tpu_torch.ops import intersect as ix
    from rabbittclust_tpu_torch.ops.pack import planes_to_device
    rec = {}
    radio = size_ratio_limit(THRESHOLD, kssd_params().kmer_size - 1)

    def note(name, ms, plain_ms, bnd):
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound", bnd)):
            rec[name][key].append(val)

    rb = 4096
    # (label, corpus, tile, mask cases: (start_index, n) of the timed
    # full tile, then one with start_index and a ragged n cutting it)
    cases = [("1plane", hashes, 4096, 0, [(0, len(hashes)), (5000, 7001)]),
             ("2plane", make_corpus(rb, SKETCH, N_CLUSTERS, SEED + 1,
                                    np.uint64), 0, 0, [(0, rb), (999, 3333)])]
    for label, hs, r0, c0, mask_cases in cases:
        use64 = hs[0].dtype == np.uint64
        planes = 1 + int(use64)
        pk = pack_sketches(hs, use64, pad_n_to=rb)
        pl = planes_to_device(pk, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cf = pl.compact()
        torch.cuda.synchronize()
        build_ms = 1e3 * (time.perf_counter() - t0)
        build_peak = torch.cuda.max_memory_allocated() - held
        builds = build_turns([(pl.plane0, pl.plane1)])
        form = sum(t.numel() * t.element_size() for t in (
            cf.v0, cf.v1, cf.g0, cf.g1, cf.gid, cf.occ, cf.start, cf.goff,
            cf.padsq) if t is not None)
        say(f"compact form {label}: N={pk.n} W={pk.width} K={pk.k}, "
            f"{cf.entries} real entries of {pk.n * pk.width * pk.k} slots, "
            f"{form} B (planes {pk.n * pk.width * pk.k * 4 * planes} B), "
            f"built on the card in {build_ms:.3f} ms (peak {build_peak} B "
            f"above the planes); {builds}")
        # K4 in turns with the parent's kernel (over the parent's own,
        # unsorted form) under --parent, outputs equal
        pix = PARENT.get("ix")
        tiles = ([r0], [c0], [1])
        ab = ab_times(lambda: ix.pair_counts_tiles(
            pl.plane0, pl.plane1, *tiles, rb), pix and (
            lambda: pix.pair_counts_tiles(pl.plane0, pl.plane1, *tiles,
                                          rb)), reps=5)
        got, k_dev, k_call, _ = ab["change"]
        want, plain_ms = cuda_ms(lambda: _k4_plain_tile(pl, r0, c0, rb),
                                 warmup=False)
        hold_exact(rec, "pair_counts_tiles", got[0], want, f"{label} tile")
        occ = occupancy(pl)
        nested = block_compares(occ, r0, rb, c0, rb)
        work = join_work(cf, r0, rb, cf, c0, rb)
        read = compact_bytes(cf, r0, r0 + rb, planes) + (
            0 if r0 == c0 else compact_bytes(cf, c0, c0 + rb, planes))
        k4_bound = join_bound(read + rb * rb * 4, work)
        note("pair_counts_tiles", k_dev[0], plain_ms, k4_bound)
        rec["pair_counts_tiles"].setdefault("call_ms", k_call[0])
        say(f"K4 {label}: tile ({r0},{c0}) of rb={rb}: exact; kernel "
            f"{fmt_ms(k_dev)} ms, call {fmt_ms(k_call)} ms"
            f"{parent_turns(ab, 'counts', want, lambda o: o[0])}; plain "
            f"{plain_ms:.3f} ms; pairs with common>0: "
            f"{int((want > 0).sum())}; the join visits {work[0]} entries "
            f"and makes {work[1]} matches (the nested loop's compares "
            f"{nested}; the plain form's W^2 K rb^2 = "
            f"{pk.width ** 2 * pk.k * rb * rb}); bytes of the compact form "
            f"read {read}; bound {k4_bound[0]:.4f} ms ({k4_bound[1]}), "
            f"kernel at {k4_bound[0] / k_dev[0]:.4f} of it")
        del got
        # the mask mode at the same tile: the timed full tile, then
        # start_index and a ragged n cutting through it; each beside an
        # invalid slot, against the plain epilogue over the plain counts
        counts = torch.stack([want, torch.zeros_like(want)])
        for m, (start, n) in enumerate(mask_cases):
            args = (pl.plane0, pl.plane1, pl.sizes, [r0, 0], [c0, 0], [1, 0],
                    radio, start, n, rb)
            ab = ab_times(lambda: ix.pair_mask_tiles(*args), pix and (
                lambda: pix.pair_mask_tiles(*args)), reps=5)
            (cnt, packs), m_dev, m_call, parts = ab["change"]
            (want_c, want_p), epi_ms = cuda_ms(lambda: ix.mask_epilogue(
                counts, pl.sizes, [r0, 0], [c0, 0], [1, 0], radio, start, n,
                rb), warmup=False)
            what = f"{label} start_index={start} n={n}"
            hold_exact(rec, "pair_mask_tiles", cnt, want_c, f"{what} counts")
            hold_exact(rec, "pair_mask_tiles", packs, want_p, f"{what} masks")
            ones = int(np.unpackbits(packs.cpu().numpy()).sum())
            if ones != int(cnt.sum()):
                raise AssertionError(f"{what}: count {cnt.tolist()} is not "
                                     f"the popcount {ones} of the mask")
            live = live_blocks(origins(r0, rb), origins(c0, rb), True, start,
                               n)
            nested_m = block_compares(occ, r0, rb, c0, rb, live)
            work_m = join_work(cf, r0, rb, cf, c0, rb, live)
            bound_m = join_bound(read + 2 * rb * 4 + rb * rb // 8 + 8,
                                 work_m)
            if m == 0:
                note("pair_mask_tiles", m_dev[0], plain_ms + epi_ms, bound_m)
                rec["pair_mask_tiles"].setdefault("call_ms", m_call[0])
                m_ms = m_dev[0]
            say(f"K4 mask {what}: counts {cnt.tolist()}: exact, popcount of "
                f"the mask; kernels {fmt_ms(m_dev)} ms ({fmt_parts(parts)}),"
                f" call {fmt_ms(m_call)} ms"
                f"{parent_turns(ab, 'masks', (want_c, want_p))}; plain "
                f"counts + epilogue {plain_ms + epi_ms:.3f} ms; the join "
                f"visits {work_m[0]} entries and makes {work_m[1]} matches "
                f"(the nested loop's compares {nested_m}); bound "
                f"{bound_m[0]:.4f} ms ({bound_m[1]}), kernels at "
                f"{bound_m[0] / m_dev[0]:.4f} of it")
        if label == "1plane":  # off the diagonal: no pad term in want
            library_call(rec, {"pair_counts_tiles": k_dev[0],
                               "pair_mask_tiles": m_ms}, (cf, r0, rb),
                         (cf, c0, rb), lambda d: torch.equal(d, want),
                         f"K4 {label} tile ({r0},{c0})")
        del counts, want
        rng = np.random.default_rng(1)
        ii = rng.integers(0, len(hs), size=100_000)
        jj = rng.integers(0, len(hs), size=100_000)
        # the kernel alone on pairs already on the card, and the wrapper's
        # call from host arrays (the engine's), which uploads them
        pairs = torch.from_numpy(np.stack([ii, jj]).astype(np.int32)).to(dev)
        got, ms = cuda_ms(lambda: ix.pair_common_launch(
            pl.plane0, pl.plane1, pairs), reps=10)
        got_w, call_ms = cuda_ms(lambda: ix.pair_common(
            pl.plane0, pl.plane1, ii, jj), reps=3)
        hold_exact(rec, "pair_common", got_w, got, f"{label} wrapper")
        it, jt = torch.from_numpy(ii).to(dev), torch.from_numpy(jj).to(dev)
        want, plain_ms = cuda_ms(lambda: ix.pair_common_plain(
            pl.plane0, pl.plane1, it, jt))
        hold_exact(rec, "pair_common", got, want, label)
        need = sum(int((occ[it[s:s + 10_000]] * occ[jt[s:s + 10_000]]).sum())
                   for s in range(0, len(ii), 10_000))
        touched = torch.from_numpy(np.union1d(ii, jj)).to(dev)
        sizes = cf.start[1:len(hs) + 1] - cf.start[:len(hs)]
        read = int(sizes[touched].sum()) * 4 * planes + len(touched) * pk.k
        k5_bound = bound(read + 12 * len(ii), need, CORE_OPS)
        note("pair_common", ms, plain_ms, k5_bound)
        say(f"K5b {label}: 100000 random pairs: exact; kernel {ms:.3f} ms "
            f"(the wrapper's call from host arrays {call_ms:.3f} ms), plain "
            f"{plain_ms:.3f} ms; compares needed {need}; bytes of the "
            f"compact form read {read}; bound {k5_bound[0]:.4f} ms "
            f"({k5_bound[1]}), kernel at {k5_bound[0] / ms:.4f} of it")
        del pl, cf, got, got_w, want, pairs
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
            want = torch.zeros_like(got)
            for t in range(4):
                want[t] = _k4_plain_tile(pl, r0s[t], c0s[t], 128, rows=128)
                hold_exact(rec, "pair_counts_tiles", got[t], want[t],
                           f"small W={pk.width} tile {t}")
            for start, n in ((0, 300), (150, 290)):
                args = (r0s, c0s, val, radio, start, n, 128)
                cnt, packs = ix.pair_mask_tiles(pl.plane0, pl.plane1,
                                                pl.sizes, *args)
                want_c, want_p = ix.mask_epilogue(want, pl.sizes, *args)
                what = f"small W={pk.width} start_index={start} n={n}"
                hold_exact(rec, "pair_mask_tiles", cnt, want_c,
                           f"{what} counts")
                hold_exact(rec, "pair_mask_tiles", packs, want_p,
                           f"{what} masks")
            ii = np.random.default_rng(2).integers(0, 300, size=(2, 5000))
            hold_exact(rec, "pair_common",
                       ix.pair_common(pl.plane0, pl.plane1, *ii),
                       ix.pair_common_plain(pl.plane0, pl.plane1,
                                            *torch.from_numpy(ii).to(dev)),
                       f"small W={pk.width}")
            say(f"small ragged {'2plane' if use64 else '1plane'} "
                f"W={pk.width} K={pk.k} N=300->{pk.n}: counts, masks and "
                "pair counts exact")
    # the stats mode is phase 3i's
    if min(v for k, v in ix.LAUNCHES.items() if k != "pair_stats_tiles") <= 0:
        raise AssertionError(f"launch counters did not move: {ix.LAUNCHES}")
    return rec


def kssd_params():
    from rabbittclust_tpu_torch.sketch.kssd import KssdParams
    p = KssdParams.from_kmer_size(21, 3)
    assert not p.use64
    return p


def save_presketched(hashes, folder):
    """The corpus as a --presketched run folder of genomes genome_<i>."""
    from rabbittclust_tpu_torch.sketch.base import SketchSet
    from rabbittclust_tpu_torch.state import sketch_io
    p = kssd_params()
    ss = SketchSet("kssd", p, True, p.use64)
    for i, h in enumerate(hashes):
        ss.append_genome(file_name=f"genome_{i}.fna", name=f"genome_{i}",
                         comment=f"cluster{i % N_CLUSTERS}",
                         seq0_len=3_000_000, total_len=3_000_000,
                         num_seqs=1, hashes=h)
    sketch_io.save_kssd_sketches(ss, p, folder)
    return p


def read_cluster_file(path):
    """Member genome ids of each cluster of a by-file ``.cluster`` file."""
    clusters = []
    with open(path) as f:
        for line in f:
            if line.startswith("the cluster"):
                clusters.append([])
            elif line.startswith("\t"):
                clusters[-1].append(int(line.split("\t")[2]))
    return clusters


def phase_end_to_end(hashes, dev, tmp):
    say(f"== phase 4: clust-mst --fast --device --presketched, "
        f"N={len(hashes)}")
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.cluster.mst import (
        clusters_from_forest, compute_mst, cut_forest)
    from rabbittclust_tpu_torch.state import sketch_io
    from rabbittclust_tpu_torch.ops import intersect as ix

    folder = os.path.join(tmp, "sketches")
    p = save_presketched(hashes, folder)
    out = os.path.join(tmp, "slice.cluster")

    ix.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # before the run, in the peak
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
    if min(launches["pair_mask_tiles"], launches["pair_common"]) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{launches}")
    if launches["pair_counts_tiles"]:
        raise AssertionError("the dense engine wrote (batch, rb, rb) counts "
                             f"to device memory: {launches}")

    t0 = time.perf_counter()
    ref = compute_mst(hashes, THRESHOLD, p.kmer_size)
    host_s = time.perf_counter() - t0
    mst = sketch_io.load_mst(folder)
    n = len(hashes)
    rel = hold_mst(mst, ref.mst, n, "dense engine")
    got = partition(clusters_from_forest(cut_forest(mst, THRESHOLD), n))
    want = partition(clusters_from_forest(cut_forest(ref.mst, THRESHOLD),
                                          n))
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
            "pack_s", "h2d_s", "compact_s", "dispatch_s", "sweep_wait_s",
            "decode_s", "pair_common_s", "edges_s", "kruskal_s", "mst_s",
            "outputs_s")))
    say(f"device (CUDA events): tile sweep {stats['sweep_ms']:.3f} ms, "
        f"pair-common {stats['pair_common_ms']:.3f} ms; busy share of the "
        f"engine wall ~{busy / stats['mst_s']:.3f}")
    say(f"wall {wall:.3f} s (host engine {host_s:.3f} s); "
        f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB; "
        f"{held} B of it held before the run); tiles {stats['tiles']}, "
        f"batches {stats['batches']}, candidates {stats['candidates']}; "
        f"launches {launches}")
    return launches, want, ref.mst, mst


def phase_from_fasta(tmp):
    say("== phase 5: clust-mst --fast --device -l -i list (from FASTA)")
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.cluster.mst import (
        clusters_from_forest, cut_forest)
    from rabbittclust_tpu_torch.state import sketch_io
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


def hold_exact(rec, name, got, want, what):
    """Kernel output ``got`` must equal the plain version's ``want``."""
    entry = rec.setdefault(name, {"err": 0, "ms": [], "plain_ms": [],
                                  "bound": []})
    if got.shape != want.shape:
        raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = 0 if got.numel() == 0 or torch.equal(got, want) else \
        int((got.long() - want.long()).abs().max())
    entry["err"] = max(entry["err"], err)
    if err:
        raise AssertionError(f"{name} {what}: max |kernel - plain| = {err} "
                             "(must be 0)")


def b1_rate(dev):
    """Operations/s of the card's single-bit tensor-core products, two a
    bit multiply-add as int8 rates count them: the faster of ``mma.sync
    m16n8k256 .b1 .and.popc`` (K1's, K6's) and ``wgmma m64n256k256 .b1``
    (the ring step's).  NVIDIA publishes no such rate for the H100, so both
    are measured: register-only chains of the mma.sync form
    (``filter_mask.cu::mma_b1_peak_kernel``), 4, 8 or 16 independent
    chains a thread at two launch shapes, and warpgroups issuing the wgmma
    form on shared-memory operands (``ring_step.cu::wgmma_b1_peak_kernel``)
    1, 2 or 3 a CTA, each launch ~1 ms or more; the fastest.  Every .b1
    bound takes it."""
    from rabbittclust_tpu_torch.kernels import _build
    lib = _build.load_kernels()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    best = 0.0
    for chains in (4, 8, 16):
        iters = 32768 // chains
        for per_sm, threads in ((2, 256), (4, 256)):
            blocks = sms * per_sm
            out = torch.empty(blocks * threads, dtype=torch.int32,
                              device=dev)

            def run():
                rc = lib.rtc_mma_b1_peak(chains, blocks, threads, iters,
                                         out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"rtc_mma_b1_peak: CUDA error {rc}")

            _, ms = cuda_ms(run, reps=5)
            rate = (blocks * threads // 32 * iters * chains * 2 * 16 * 8
                    * 256 / (ms * 1e-3))
            say(f"mma.sync m16n8k256 .b1 .and.popc alone: {blocks} blocks x"
                f" {threads} threads, {chains} chains of {iters}: "
                f"{ms:.4f} ms, {rate / 1e12:.1f} TOP/s")
            best = max(best, rate)
    mma = best
    out = torch.empty(sms * 384, dtype=torch.int32, device=dev)
    for threads in (128, 256, 384):
        iters = 1024

        def run():
            rc = lib.rtc_wgmma_b1_peak(sms, threads, iters, out.data_ptr(),
                                       stream)
            if rc:
                raise RuntimeError(f"rtc_wgmma_b1_peak: CUDA error {rc}")

        _, ms = cuda_ms(run, reps=5)
        rate = (sms * threads // 128 * iters * 16 * 2 * 64 * 256 * 256
                / (ms * 1e-3))
        say(f"wgmma m64n256k256 .b1 .and.popc alone: {sms} blocks x "
            f"{threads // 128} warpgroups, {iters} groups of 16: {ms:.4f} "
            f"ms, {rate / 1e12:.1f} TOP/s")
        best = max(best, rate)
    say(f"the .b1 rate for every .b1 bound: {best / 1e12:.1f} TOP/s (the "
        f"wgmma form at {best / mma:.2f}x the mma.sync form's "
        f"{mma / 1e12:.1f})")
    return best


def k1_bound(rb, bits, b1_ops):
    """K1's bound per tile: the rb^2 bits bit multiply-adds of the
    shared-bit product, two operations each, at ``b1_ops`` (the measured
    rate of K1's instruction); its bytes are the tile's two signature row
    blocks and its packed mask."""
    return bound(2 * rb * bits // 8 + rb * rb // 8, 2 * rb * rb * bits,
                 b1_ops)


def bf16_product_ms(bm, xd, r0, c0, rb):
    """The shared-bit product of tile (r0, c0) alone as one bfloat16
    ``torch.mm`` with a float32 result (exact for 0/1 operands): milliseconds,
    and whether it equals the float32 product."""
    xi = bm.unpack_bits(xd[r0:r0 + rb], torch.bfloat16)
    xj = bm.unpack_bits(xd[c0:c0 + rb], torch.bfloat16)
    b16, ms = cuda_ms(lambda: torch.mm(xi, xj.T, out_dtype=torch.float32),
                      reps=5)
    return b16, ms


def say_k1(rb, ms, mm_ms, card, b1_ops):
    b, by = k1_bound(rb, BITS, b1_ops)
    int8 = 1e3 * 2 * rb * rb * BITS / INT8_TC_OPS
    say(f"K1 per {rb}^2 tile at {BITS} bits: {ms:.4f} ms; bfloat16 torch.mm "
        f"of the same product {mm_ms:.4f} ms (same call); bound {b:.4f} ms "
        f"({by}, at the measured .b1 rate {b1_ops / 1e12:.1f} TOP/s); K1 at "
        f"{b / ms:.3f} of the bound; the same operations at the published "
        f"int8 rate take {int8:.4f} ms (an s8 product's floor, not this "
        f"kernel's); card {card}")


def phase_filter_kernel(hashes, dev, rec, card):
    say("== phase 3b: K1 (filter_mask) against batched_mask_plain")
    from rabbittclust_tpu_torch.ops import bitmap as bm
    b1_ops = b1_rate(dev)
    k = kssd_params().kmer_size
    # 3.5 row blocks of genomes: the last row block is padded
    sig = bm.stage_signatures(hashes[:3 * RB + RB // 2], BITS, RB, dev)
    sc = bm.filter_scalars(THRESHOLD, k)
    tiles = (np.array([RB, 2 * RB, 3 * RB, 0]), np.array([RB, 0, RB, 0]),
             np.array([1, 1, 1, 0]))
    (cnt, packs), ms = cuda_ms(lambda: bm.batched_mask(
        sig.xd, sig.cd, sig.sd, *tiles, *sc, False, RB), reps=5)
    (want_c, want_p), plain_ms = cuda_ms(lambda: bm.batched_mask_plain(
        sig.xd, sig.cd, sig.sd, *tiles, *sc, False, RB))
    hold_exact(rec, "filter_mask", cnt, want_c, f"rb={RB} counts")
    hold_exact(rec, "filter_mask", packs, want_p, f"rb={RB} masks")
    rec["filter_mask"]["ms"].append(ms / 3)
    rec["filter_mask"]["plain_ms"].append(plain_ms / 3)
    rec["filter_mask"]["bound"].append(k1_bound(RB, BITS, b1_ops))
    say(f"K1 rb={RB} bits={BITS}: tiles ({RB},{RB}) diagonal, "
        f"({2 * RB},0), ({3 * RB},{RB}) padded, one invalid slot; counts "
        f"{cnt.tolist()}: exact; kernel {ms / 3:.3f} ms per tile, plain "
        f"{plain_ms / 3:.3f} ms per tile")
    # the shared-bit product alone, the floor of any plain version built on
    # it: float32 on the CUDA cores (the plain version's) and bfloat16 on
    # the tensor cores with a float32 result; both exact for 0/1 operands
    xi = bm.unpack_bits(sig.xd[2 * RB:3 * RB])
    xj = bm.unpack_bits(sig.xd[:RB])
    f32, f32_ms = cuda_ms(lambda: xi @ xj.T, reps=5)
    del xi, xj
    b16, b16_ms = bf16_product_ms(bm, sig.xd, 2 * RB, 0, RB)
    if not torch.equal(b16, f32):
        raise AssertionError("the bfloat16 product differs from the float32 "
                             "product")
    rec["filter_mask"]["library_ms"] = b16_ms
    say(f"K1 tile ({2 * RB},0) shared-bit product alone: float32 "
        f"{f32_ms:.3f} ms, bfloat16 (mm out_dtype=float32) {b16_ms:.3f} ms,"
        f" equal; K1 (whole mask) {ms / 3:.3f} ms per tile")
    say_k1(RB, ms / 3, b16_ms, card, b1_ops)
    del sig, packs, want_p, f32, b16
    small = make_corpus(300, 150, 8, SEED)
    rng = np.random.default_rng(5)
    base = np.unique(rng.integers(0, 2 ** 31, 500).astype(np.uint32))
    contained = [np.unique(np.concatenate([
        rng.choice(base, size=int(t), replace=False),
        rng.integers(0, 2 ** 31, int(t) // 5).astype(np.uint32)]))
        for t in rng.integers(80, 500, 300)]
    # rb = 128 at 1024 bits; ragged rb (a multiple of 32, not of the
    # kernel's 128-pair block tile) and signatures shorter than one stage
    for rb, bits in ((128, 1024), (96, 64), (160, 128), (96, 8192)):
        n_pad = -(-300 // rb) * rb
        last = n_pad - rb
        tiles = (np.array([0, rb, last, last, 0]),
                 np.array([0, 0, rb, last, 0]), np.array([1, 1, 1, 1, 0]))
        for bound_name in ("mst", "greedy", "minhash"):
            for cont, hs in ((False, small), (True, contained)):
                sizes = [len(h) for h in hs]
                sig = bm.stage_signatures(hs, bits, rb, dev, bound_name,
                                          col_sizes=sizes[::-1])
                args = (sig.xd, sig.cd, sig.sd, *tiles,
                        *bm.filter_scalars(THRESHOLD, 21, bound_name), cont,
                        rb, bound_name)
                got = bm.batched_mask(*args)
                want = bm.batched_mask_plain(*args)
                what = (f"small rb={rb} bits={bits} {bound_name} "
                        f"{'aaf' if cont else 'mash'}")
                hold_exact(rec, "filter_mask", got[0], want[0], what)
                hold_exact(rec, "filter_mask", got[1], want[1], what)
        say(f"K1 small (N=300 -> {n_pad}, {bits} bits, rb={rb}, tiles "
            f"{tiles[0].tolist()} x {tiles[1].tolist()}, the last invalid): "
            "bounds mst, greedy, minhash x mash, containment: exact")
    return b1_ops


def clear_targets(packs, rng, n_bytes=400):
    """(4, C) int32 clear list over set bits of ``packs``: every bit of
    random nonzero bytes, half of them bytes with several set bits (so
    (tile, row, byte) targets repeat), then no-op padding."""
    t, r, b = np.nonzero(packs)
    nbits = np.unpackbits(packs[t, r, b][:, None], axis=1).sum(1)
    multi = rng.permutation(np.flatnonzero(nbits >= 2))[:n_bytes // 2]
    single = rng.permutation(np.flatnonzero(nbits == 1))
    pick = np.concatenate([multi, single[:n_bytes - len(multi)]])
    ents = [(t[q], r[q], b[q], 1 << k) for q in pick for k in range(8)
            if packs[t[q], r[q], b[q]] >> k & 1]
    out = np.zeros((4, 4096), dtype=np.int32)
    out[:, :len(ents)] = np.array(ents, dtype=np.int64).T
    return out


def build_masks(hashes, rb, dev, part=slice(None)):
    """K1's masks of the tiles ``part`` of the triangular sweep of
    ``hashes`` at ``rb``: (signatures, geometry (3, T) int64, packs,
    milliseconds of the build)."""
    from rabbittclust_tpu_torch.ops import bitmap as bm
    sig = bm.stage_signatures(hashes, BITS, rb, dev)
    tiles = bm.triangle_tiles(sig.n_pad, rb)[part]
    geo = np.array([[r for r, _ in tiles], [c for _, c in tiles],
                    [1] * len(tiles)], dtype=np.int64)
    (_, packs), ms = cuda_ms(lambda: bm.batched_mask(
        sig.xd, sig.cd, sig.sd, *geo,
        *bm.filter_scalars(THRESHOLD, kssd_params().kmer_size), False, rb),
        warmup=False)
    return sig, geo, packs, ms


def mixed_labels(planted, rng):
    """Half the genomes keep their planted cluster's label, the rest get a
    label of their own: the masks hold same- and cross-label bits."""
    ids = np.arange(len(planted))
    return np.where(rng.random(len(planted)) < 0.5, planted,
                    N_CLUSTERS + ids).astype(np.int32)


def label_mixes(planted, rng):
    """K2's label mixes: mixed first (the kernels line's case, timed the
    same way since the port's first K2), every genome its own label (round
    1 of the engine) and the planted clusters' labels (round 2, once round
    1 has joined them)."""
    return [("mixed", mixed_labels(planted, rng)),
            ("distinct", np.arange(len(planted), dtype=np.int32)),
            ("planted", planted.astype(np.int32))]


def round_cases(rec, what, packs, geo, mixes, clr_np, rb, cases, dev,
                need_repeats=True):
    """K2 against its plain versions on copies of ``packs``, under each
    label mix of ``mixes`` ((name, labels)); ``cases`` are (label, None)
    for the full round and (label, (r_lo, span, cap)) for the compact one.
    Kernel and plain outputs and updated masks exactly equal.  Returns
    {(mix, label): kernel ms}."""
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.ops import labelprop as lp
    geo_d = torch.from_numpy(geo.astype(np.int32)).to(dev)
    clr = torch.from_numpy(clr_np).to(dev)
    live = clr_np[3] > 0
    repeats = int(live.sum()) - len({tuple(e) for e in clr_np[:3].T[live]})
    if need_repeats and not repeats:
        raise AssertionError(f"{what}: the clear list repeats no target")
    # the bound: the masks read once, labels and clear list in, the round's
    # outputs out; one label compare for each set bit of the masks
    set_bits = sum(int(bm.unpack_bits(t, torch.uint8).sum(dtype=torch.int64))
                   for t in packs)
    times = {}
    for mix, labels in mixes:
        labels_d = torch.from_numpy(labels).to(dev)
        for label, compact in cases:
            mine, ref = packs.clone(), packs.clone()
            if compact is None:
                got, ms = cuda_ms(lambda: lp.lp_round(mine, labels_d, clr,
                                                      *geo_d, rb), reps=5)
                want, plain_ms = cuda_ms(lambda: lp.round_plain(
                    ref, labels_d, clr, *geo_d, rb), warmup=False)
            else:
                r_lo, span, cap = compact
                args = (labels_d, clr, *geo_d, r_lo, rb, span, cap)
                got, ms = cuda_ms(lambda: lp.lp_round_compact(mine, *args),
                                  reps=5)
                want, plain_ms = cuda_ms(lambda: lp.round_compact_plain(
                    ref, *args), warmup=False)
            case = f"{what} {mix} labels, {label}"
            hold_exact(rec, "labelprop_round", got, want, case)
            hold_exact(rec, "labelprop_round", mine, ref, f"{case} masks")
            if torch.equal(mine, packs):
                raise AssertionError(f"{case}: the clear list left the masks"
                                     " as they were")
            k2_bound = bound(packs.numel() + 4 * labels_d.numel()
                             + 4 * clr.numel() + 4 * got.numel(), set_bits,
                             CORE_OPS)
            rec["labelprop_round"]["ms"].append(ms)
            rec["labelprop_round"]["plain_ms"].append(plain_ms)
            rec["labelprop_round"]["bound"].append(k2_bound)
            times[mix, label] = ms
            extra = f", ncol {int(want[1])}" if compact else ""
            say(f"K2 {case}: {len(geo[0])} tiles of rb={rb}, clear list "
                f"{int(live.sum())} bits ({repeats} repeated targets), "
                f"{set_bits} set bits, cross {int(want[0])}{extra}: exact; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
                f"{k2_bound[0]:.4f} ms ({k2_bound[1]}), kernel at "
                f"{k2_bound[0] / ms:.3f} of it")
            del mine, ref, got, want
            torch.cuda.empty_cache()
    return times


def parent_round(packs, geo, labels, clr_np, rb, dev, what, card):
    """K2's full round over ``packs`` against the parent's, each on its own
    copy, by ``device_ms`` in turns parent, this, this, parent: outputs and
    cleared masks equal."""
    from rabbittclust_tpu_torch.ops import labelprop as lp
    plp = PARENT["lp"]
    geo_d = torch.from_numpy(geo.astype(np.int32)).to(dev)
    labels_d = torch.from_numpy(labels).to(dev)
    clr = torch.from_numpy(clr_np).to(dev)
    mine, theirs = packs.clone(), packs.clone()
    ab = ab_times(lambda: lp.lp_round(mine, labels_d, clr, *geo_d, rb),
                  lambda: plp.lp_round(theirs, labels_d, clr, *geo_d, rb))
    if not (torch.equal(ab["change"][0], ab["parent"][0])
            and torch.equal(mine, theirs)):
        raise AssertionError(f"K2 {what}: the parent's round differs")
    say(f"K2 {what} against the parent's: kernels "
        f"{fmt_ms(ab['change'][1])} ms, call {fmt_ms(ab['change'][2])} ms "
        f"({fmt_parts(ab['change'][3])}); the parent's kernels "
        f"{fmt_ms(ab['parent'][1])} ms, call {fmt_ms(ab['parent'][2])} ms "
        f"({fmt_parts(ab['parent'][3])}) (in turns parent, this, this, "
        f"parent; outputs and masks equal); this at "
        f"{ab['change'][1][0] / ab['parent'][1][0]:.3f} of it; card {card}")
    del mine, theirs, ab
    torch.cuda.empty_cache()


def panel_clear_list(packs, rng):
    """A clear list over bits of the first tile and of the last 4."""
    n_t = packs.shape[0]
    late = clear_targets(packs[-4:].cpu().numpy(), rng)
    late[0] += n_t - 4
    return np.concatenate([clear_targets(packs[:1].cpu().numpy(), rng),
                           late], axis=1)


def phase_compaction(dev, rec, round_ms):
    """K2's compaction alone, over a synthetic round output (half the
    columns proposing), at n_pad 131,072 (span n_pad) and 1,048,576 (span
    262,144, a 512-tile panel's rows at rb = 8192), cap 65,536; its share of
    the compact round over panel 0 (``round_ms``)."""
    from rabbittclust_tpu_torch.kernels import _build
    from rabbittclust_tpu_torch.ops import labelprop as lp
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(9)
    cap = 65536
    for n_pad, span in ((131072, 131072), (1048576, 262144)):
        fused_np = rng.integers(0, n_pad, 1 + 2 * n_pad).astype(np.int32)
        fused_np[1 + n_pad:][rng.random(n_pad) < 0.5] = lp.SENT
        fused = torch.from_numpy(fused_np).to(dev)
        want = lp.compact_plain(fused, n_pad, 0, span, cap)
        n_bytes = 4 * (n_pad + span + want.numel())
        c_bound = bound(n_bytes, 0, CORE_OPS)
        work = fused.clone()  # the compaction overwrites row_p's head
        out = torch.empty_like(want)

        def run():
            rc = lib.rtc_lp_compact(work.data_ptr(), n_pad, 0, span, cap,
                                    out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"rtc_lp_compact: CUDA error {rc}")
            return out

        run()
        torch.cuda.synchronize()
        hold_exact(rec, "labelprop_round", out, want,
                   f"compaction n_pad={n_pad}")
        _, ms = cuda_ms(run, reps=20, warmup=False)
        say(f"K2 compaction alone: n_pad={n_pad} span={span} cap={cap}, "
            f"ncol {int(want[1])}: exact; {ms:.4f} ms, {ms / round_ms:.3f} "
            f"of panel 0's compact round ({round_ms:.4f} ms); bound "
            f"{c_bound[0]:.4f} ms (bytes)")
        del work, out


def phase_round_kernel(corpus, dev, rec, card, b1_ops):
    say("== phase 3c: K2 (labelprop_round) against its plain versions")
    from rabbittclust_tpu_torch.ops import bitmap as bm
    rng = np.random.default_rng(3)
    # (a) the main path's shapes: panel 0 of the N = 131,072 sweep (512
    # tiles, n_pad 131,072) and its compact pull (span n_pad, cap 65,536);
    # the clear list names bits of the panel's first and last 4 tiles;
    # then the whole sweep at rb = 8192 (136 tiles, one panel)
    n = len(corpus)
    times = {}
    for rb, part in ((RB, slice(512)), (2 * RB, slice(None))):
        sig, geo, packs, build_ms = build_masks(corpus, rb, dev, part)
        n_pad, n_t = sig.n_pad, len(geo[0])
        del sig
        say(f"K1 panel 0 of N={n}: {n_t} tiles of rb={rb} in "
            f"{build_ms:.3f} ms ({build_ms / n_t:.3f} ms per tile)")
        clr_np = panel_clear_list(packs, rng)
        mixes = label_mixes(np.arange(n_pad) % N_CLUSTERS, rng)
        times[rb] = round_cases(
            rec, f"N={n} panel 0", packs, geo, mixes, clr_np, rb,
            [("full", None),
             ("compact span=n_pad cap=65536", (0, n_pad, 65536))],
            dev, need_repeats=False)
        if PARENT:
            parent_round(packs, geo, mixes[0][1], clr_np, rb, dev,
                         f"N={n} panel 0 ({n_t} tiles of rb={rb}), mixed "
                         "labels, full", card)
        del packs
        torch.cuda.empty_cache()
    # (b) cluster members side by side (genome i moves to cluster i % 64's
    # block), so mask bytes hold several set bits and clear targets repeat;
    # at rb = 4096 and at rb = 8192 (K2's shared memory past 48 KB, and K1
    # held to its plain version there too)
    hashes = corpus[:N_GENOMES]
    order = np.argsort(np.arange(N_GENOMES) % N_CLUSTERS, kind="stable")
    grouped = [hashes[i] for i in order]
    planted = np.arange(N_GENOMES) * N_CLUSTERS // N_GENOMES
    for rb, cases in (
            (RB, [("full", None), ("compact cap=65536", (RB, 2 * RB, 65536)),
                  ("compact cap=100", (RB, 2 * RB, 100))]),
            (2 * RB, [("full", None),
                      ("compact cap=4096", (2 * RB, 2 * RB, 4096))])):
        sig, geo, packs, _ = build_masks(grouped, rb, dev)
        if rb != RB:
            args = (sig.xd, sig.cd, sig.sd, *geo,
                    *bm.filter_scalars(THRESHOLD, kssd_params().kmer_size),
                    False, rb)
            (cnt, _), ms = cuda_ms(lambda: bm.batched_mask(*args), reps=3)
            want_c, want_p = bm.batched_mask_plain(*args)
            hold_exact(rec, "filter_mask", cnt, want_c, f"rb={rb} counts")
            hold_exact(rec, "filter_mask", packs, want_p, f"rb={rb} masks")
            say(f"K1 rb={rb} bits={BITS}, N={N_GENOMES} grouped: "
                f"{len(geo[0])} tiles, counts {cnt.tolist()}: exact; kernel "
                f"{ms / len(geo[0]):.3f} ms per tile")
            del want_p
            _, mm_ms = bf16_product_ms(bm, sig.xd, rb, 0, rb)
            say_k1(rb, ms / len(geo[0]), mm_ms, card, b1_ops)
        round_cases(rec, f"N={N_GENOMES} grouped", packs, geo,
                    [("mixed", mixed_labels(planted, rng))],
                    clear_targets(packs.cpu().numpy(), rng), rb, cases, dev)
        del sig, packs
        torch.cuda.empty_cache()
    # (c) panel 1 of the N = 131,072 sweep: the 16 tiles left after panel 0,
    # a round of few blocks
    rng = np.random.default_rng(4)
    sig, geo, packs, _ = build_masks(corpus, RB, dev, slice(512, None))
    n_pad = sig.n_pad
    del sig
    mixes = [("mixed", mixed_labels(np.arange(n_pad) % N_CLUSTERS, rng))]
    clr_np = panel_clear_list(packs, rng)
    round_cases(rec, f"N={n} panel 1", packs, geo, mixes, clr_np, RB,
                [("full", None),
                 ("compact span=n_pad cap=65536", (0, n_pad, 65536))],
                dev, need_repeats=False)
    if PARENT:
        parent_round(packs, geo, mixes[0][1], clr_np, RB, dev,
                     f"N={n} panel 1 ({len(geo[0])} tiles of rb={RB}), mixed "
                     "labels, full", card)
    del packs
    torch.cuda.empty_cache()
    phase_compaction(dev, rec, times[RB][
        "mixed", "compact span=n_pad cap=65536"])


def k3_slab(corpus, dev):
    """One shard's slab of the bitmap ring at N = 131,072 over 8 shards
    (shard 7: 5 steps of 16384^2, the close's shape) and its counts, both
    on the card, filled by the ring step's kernel."""
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    sc = bm.filter_scalars(THRESHOLD, kssd_params().kmer_size)
    n_dev, top = 8, 7
    mesh = de.make_mesh(devices=[dev] * n_dev)
    xp, coll = bm.pack_bitmaps_packed(corpus, BITS, pad_n_to=n_dev)
    sizes = np.array([len(h) for h in corpus], dtype=np.int32)
    shards = de._bit_shards(xp, coll, sizes, mesh)
    del xp
    shard = shards[0].xp.shape[0]
    steps = de._n_ring_steps(n_dev)
    slab = torch.zeros((steps, shard, shard // 8), dtype=torch.uint8,
                       device=dev)
    cnt = torch.zeros(steps, dtype=torch.int32, device=dev)
    for t in range(steps):
        de.ring_masks_step(shards[top], shards[(top - t) % n_dev], t, n_dev,
                           sc[:3], int(sc[3]), False, slab[t:t + 1],
                           cnt[t:t + 1])
    del shards
    return slab, cnt


def phase_compact_kernel(planted, sparse, corpus, dev, rec, card):
    """K3 against its plain versions, and against the parent's K3 in turns
    under --parent: at the stream generator's batch (16 tiles) at rb 1024
    (the dbscan and leiden CLIs' row_block) and rb 4096, over the planted
    corpus (first 16,384 genomes: 10 tiles at rb 4096, so 6 padding slots)
    and the sparse one (pairs 16,384 apart: only tiles with r0 - c0 =
    16,384 hold a candidate); one all-ones 4096^2 tile (16,777,216
    indices); one slab of 5 steps of 16384^2 (the bitmap ring's close at
    N = 131,072, ``compact_steps``).  ``compact_masks`` (K3 from K1's
    counts on the card, then one pull of its total) must equal
    ``compact_masks_plain`` and the parent's (whose call pulls the counts
    first), and be one kernel launch a call (``LAUNCHES`` and the
    profiler); the kernels and calls are timed by ``device_ms`` in turns
    (parent, this, this, parent), the non-syncing ``compact_masks_into``
    call by CUDA events over 20 calls, beside one ``torch.nonzero`` over
    the unpacked masks and the bound.  ``batched_filter`` (K1 + K3) must
    equal ``batched_filter_plain`` over the whole buffer."""
    say("== phase 3d: K3 (mask_compact) against its plain versions")
    from rabbittclust_tpu_torch.ops import bitmap as bm
    pbm = PARENT.get("bm")
    k = kssd_params().kmer_size
    sc = bm.filter_scalars(THRESHOLD, k)
    cases = []
    for label, hashes, rb, part in (
            ("planted", planted, 1024, slice(16, 32)),
            # row panel 16,384: its first tile holds the 1,024 planted
            # pairs, the other 15 none
            ("sparse", sparse, 1024, slice(136, 152)),
            ("planted", planted, RB, slice(0, 16)),
            ("sparse", sparse, RB, slice(10, 26))):
        sig = bm.stage_signatures(hashes, BITS, rb, dev)
        tiles = bm.triangle_tiles(sig.n_pad, rb)[part]
        geo = np.zeros((3, 16), dtype=np.int64)
        geo[:, :len(tiles)] = np.array([[r for r, _ in tiles],
                                        [c for _, c in tiles],
                                        [1] * len(tiles)])
        cnt_d, packs = bm.batched_mask(sig.xd, sig.cd, sig.sd, *geo, *sc,
                                       False, rb)
        what = (f"{label} rb={rb} tiles {part.start}..{part.stop - 1} "
                f"({len(tiles)} tiles, {16 - len(tiles)} padding)")
        cases.append((what, packs, cnt_d, "masks", (sig, geo, rb)))
    ones = torch.full((1, RB, RB // 8), 0xFF, dtype=torch.uint8, device=dev)
    cases.append(("one all-ones tile of 4096^2", ones,
                  torch.tensor([RB * RB], dtype=torch.int32, device=dev),
                  "masks", None))
    slab, slab_cnt = k3_slab(corpus, dev)
    cases.append((f"a slab of {slab.shape[0]} steps of {slab.shape[1]}^2 "
                  f"(shard 7 of 8 at N={len(corpus)})", slab, slab_cnt,
                  "steps", None))
    for what, packs, cnt_d, form, filt in cases:
        cnt = cnt_d.cpu().numpy()
        sel = [t for t in range(len(cnt)) if cnt[t]]
        total, maxc = int(cnt.sum()), int(cnt.max())
        rb = packs.shape[1]
        if form == "masks":
            def change():
                return bm.compact_masks(packs, cnt_d, sel)

            def parent():
                return pbm.compact_masks(packs, cnt_d.cpu().numpy(), sel)

            def plain():
                return bm.compact_masks_plain(packs, sel)
        else:
            def change():
                return bm.compact_steps(packs, cnt_d)

            def parent():
                return pbm.compact_steps(packs, cnt_d.cpu().numpy())

            def plain():
                return torch.cat([bm.compact_masks_plain(packs, [t])
                                  for t in sel])
        change()  # the first call may grow the capacity and launch again
        n0 = bm.LAUNCHES["mask_compact"]
        change()
        n1 = bm.LAUNCHES["mask_compact"] - n0
        if n1 != 1:
            raise AssertionError(f"K3 {what}: {n1} launches a call, not one")
        t = ab_times(change, pbm and parent)
        got, devs, calls, parts = t["change"]
        kernels = sorted(p for p in parts if p != "copies")
        if parts and (len(kernels) != 1
                      or not kernels[0].startswith("mc_compact_kernel")):
            raise AssertionError(f"K3 {what}: the profiler shows {kernels}, "
                                 "not one mc_compact_kernel a call")
        want, plain_ms = cuda_ms(plain, reps=3)
        hold_exact(rec, "mask_compact", got, want, what)
        par = ""
        if pbm:
            if not torch.equal(t["parent"][0], got):
                raise AssertionError(f"K3 {what}: the parent's K3 differs")
            par = (f"; the parent's K3 (its count pull, geometry upload and "
                   f"two launches) kernels {fmt_ms(t['parent'][1])} ms, call "
                   f"{fmt_ms(t['parent'][2])} ms ("
                   f"{fmt_parts(t['parent'][3])}), output equal")
        buf = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
        # as the stream generator and the ring's close call it: every tile,
        # no selection uploaded
        _, into_ms = cuda_ms(lambda: bm.compact_masks_into(
            packs, cnt_d, buf, total,
            codes="slots" if form == "masks" else "local"), reps=20)
        flags = bm.unpack_bits(packs[sel].reshape(-1, rb // 8), torch.bool) \
            if sel else torch.zeros(0, dtype=torch.bool, device=dev)
        lib, lib_ms = cuda_ms(lambda: torch.nonzero(flags.reshape(-1)),
                              reps=5)
        if lib.numel() != total:
            raise AssertionError(f"{what}: torch.nonzero found {lib.numel()}"
                                 f" set bits, the counts say {total}")
        del flags, lib
        k3_bound = bound(len(sel) * rb * rb // 8 + 4 * total, 0, CORE_OPS)
        entry = rec["mask_compact"]
        entry["ms"].append(devs[0])
        entry["plain_ms"].append(plain_ms)
        entry["bound"].append(k3_bound)
        entry.setdefault("call_ms", calls[0])
        entry.setdefault("library_ms", lib_ms)
        fused = ""
        if filt is not None:
            # K1 + K3 against the plain program, sized as the JAX generator
            # sizes its index program from the exact counts
            sig, geo, _ = filt
            grid = rb * (rb // min(512, rb))
            cap_tile, cap_chunks = max(maxc, 1), min(max(maxc, 1), grid)
            args = (sig.xd, sig.cd, sig.sd, np.arange(16), *geo, *sc, False,
                    cap_tile, cap_chunks, rb)
            fb = bm.batched_filter(*args)
            hold_exact(rec, "mask_compact", fb, bm.batched_filter_plain(*args),
                       f"{what} batched_filter")
            # compact_masks numbers the selected tiles 0, 1, ...;
            # batched_filter encodes each tile by its slot in the batch
            slots = torch.tensor(sel, dtype=torch.int64, device=dev)
            as_slots = (slots[got.long() // (rb * rb)] * (rb * rb)
                        + got.long() % (rb * rb)).to(torch.int32)
            if not torch.equal(fb[2:2 + total], as_slots):
                raise AssertionError(f"{what}: batched_filter's indices are "
                                     "not compact_masks'")
            fused = ", batched_filter whole buffer exact"
        say(f"K3 {what}, {len(cnt) - len(sel)} tiles without a candidate: "
            f"total {total}, max {maxc}: exact{fused}; one launch a call; "
            f"kernel {fmt_ms(devs)} ms ({fmt_parts(parts)}), call (with "
            f"its total's pull) {fmt_ms(calls)} ms, the non-syncing "
            f"compact_masks_into {into_ms:.4f} ms{par}; plain "
            f"{plain_ms:.3f} ms, torch.nonzero {lib_ms:.4f} ms; bound "
            f"{k3_bound[0]:.5f} ms ({k3_bound[1]}: "
            f"{len(sel) * rb * rb // 8} B of masks read, {4 * total} B "
            f"written), kernel at {k3_bound[0] / devs[0]:.3f} of it"
            + (f", the parent's at "
               f"{k3_bound[0] / min(t['parent'][1]):.3f}" if pbm else "")
            + f"; card {card}")
        del got, want, buf
    del cases, slab, ones
    torch.cuda.empty_cache()


def phase_slice(hashes, dev, tmp):
    say(f"== phase 6: clust-mst --fast --device --presketched -e, "
        f"N={len(hashes)} (MST-free main path)")
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.ops import labelprop as lp
    folder = os.path.join(tmp, "slice_sketches")
    t0 = time.perf_counter()
    save_presketched(hashes, folder)
    say(f"corpus saved in {time.perf_counter() - t0:.3f} s")
    out = os.path.join(tmp, "slice_e.cluster")
    bm.reset_launches()
    lp.reset_launches()
    bm.reset_pull_stats()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    rc = main(["--fast", "--device", "--presketched", folder, "-o", out,
               "-d", str(THRESHOLD), "-e"], stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"filter_mask": bm.LAUNCHES["filter_mask"],
                "labelprop_round": lp.LAUNCHES["labelprop_round"]}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"clust-mst returned {rc}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{launches}")
    n = len(hashes)
    got = partition(read_cluster_file(out))
    planted = partition([list(range(c, n, N_CLUSTERS))
                         for c in range(N_CLUSTERS)])
    if got != planted:
        raise AssertionError(f"{len(got)} clusters, not the "
                             f"{N_CLUSTERS} planted ones")
    st = lp.LP_STATS
    if st["panels"] != 2:
        raise AssertionError(f"expected 2 panels, ran {st['panels']}")
    busy = (st["build_ms"] + st["round_ms"]) / 1e3
    say(f"slice: {len(got)} clusters = planted; launches {launches}")
    say("LP_STATS: " + ", ".join(f"{k}={v:.3f}" if isinstance(v, float)
                                 else f"{k}={v}" for k, v in st.items()))
    say(f"device (CUDA events): builds {st['build_ms']:.3f} ms, rounds "
        f"{st['round_ms']:.3f} ms over {st['rounds']} rounds; busy share "
        f"of the engine wall ~{busy / st['total_s']:.3f}")
    say(f"wall {wall:.3f} s (clusters {stats['clusters_s']:.3f} s); pulled "
        f"{bm.PULL_STATS['bytes']} B in {bm.PULL_STATS['pulls']} pulls; "
        f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)")
    return launches


def phase_engines(hashes, want, dev):
    say(f"== phase 7: both MST-free engines at N={len(hashes)} (the stream "
        "engine under both pulls), and the -t 1 exact-order arm")
    from rabbittclust_tpu_torch.cluster.mst import (
        clusters_from_forest, compute_mst, cut_forest)
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.ops import cluster_fast as cf
    from rabbittclust_tpu_torch.ops import labelprop as lp
    k = kssd_params().kmer_size
    for engine, pull in (("stream", "auto"), ("stream", "idx"), ("lp", "auto")):
        os.environ["RTC_CLUSTER_ENGINE"] = engine
        os.environ["RTC_PULL_MODE"] = pull
        bm.reset_launches()
        lp.reset_launches()
        bm.reset_pull_stats()
        t0 = time.perf_counter()
        try:
            with Spy(bm, "compact_masks_into") as k3:
                got = cf.threshold_clusters_device(hashes, THRESHOLD, k,
                                                   device=dev)
        finally:
            del os.environ["RTC_CLUSTER_ENGINE"], os.environ["RTC_PULL_MODE"]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if partition(got) != want:
            raise AssertionError(f"{engine} engine ({pull}): partition "
                                 "differs from the host engine's")
        k1, k2 = bm.LAUNCHES["filter_mask"], lp.LAUNCHES["labelprop_round"]
        k3n = bm.LAUNCHES["mask_compact"]
        if k1 <= 0 or (k2 > 0) != (engine == "lp") or \
                (k3n > 0) != (pull == "idx") or bool(k3.calls) != (k3n > 0):
            raise AssertionError(f"{engine} engine ({pull}) launches: K1 "
                                 f"{k1}, K2 {k2}, K3 {k3n}")
        say(f"{engine} (RTC_PULL_MODE={pull}): {len(got)} clusters = host "
            f"engine's partition in {secs:.3f} s (K1 launches {k1}, K2 {k2},"
            f" K3 {k3n}; pulled {bm.PULL_STATS['bytes']} B in "
            f"{bm.PULL_STATS['pulls']} pulls)")
    small = make_corpus(2000, SKETCH, N_CLUSTERS, SEED + 2)
    t0 = time.perf_counter()
    got, certified = cf.threshold_clusters_device_exact_order(
        small, THRESHOLD, k, device=dev)
    secs = time.perf_counter() - t0
    serial = compute_mst(small, THRESHOLD, k, threads=1)
    ref = clusters_from_forest(cut_forest(serial.mst, THRESHOLD), len(small))
    if got != ref:
        raise AssertionError("-t 1 exact order differs from the native "
                             "serial engine's member order")
    say(f"-t 1 exact order, N=2000: {len(got)} clusters, member order = "
        f"the native serial engine's (certified: {certified}) in "
        f"{secs:.3f} s")


class Spy:
    """Records the arguments and results of every call of ``module.name``
    (the caller looks the name up in that module at each call) and its host
    seconds, and calls through; the wrapper's own launch count is untouched.
    ``with`` restores it."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls = []
        self.results = []
        self.seconds = 0.0

    def __enter__(self):
        def wrapper(*args, **kwargs):
            self.calls.append((args, kwargs))
            t0 = time.perf_counter()
            try:
                out = self.real(*args, **kwargs)
                self.results.append(out)
                return out
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def k1_bounds(spy):
    """The bound of each K1 call a Spy of ``bitmap.batched_mask`` saw."""
    return [a[12] if len(a) > 12 else kw.get("bound", "mst")
            for a, kw in spy.calls]


def folder_digest(folder):
    import hashlib
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def run_cli(main, argv, stats):
    """(wall seconds, launches of K1 / K4 mask mode / K5b, K1 spy, K4
    mask-mode spy, K5b spy) of one CLI run from launch counts set to 0."""
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.ops import engine
    from rabbittclust_tpu_torch.ops import intersect as ix
    bm.reset_launches()
    ix.reset_launches()
    with Spy(bm, "batched_mask") as k1, \
            Spy(engine, "pair_mask_tiles") as k4, \
            Spy(engine, "pair_common") as k5b:
        t0 = time.perf_counter()
        rc = main(argv, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{argv[:3]}... returned {rc}")
    launches = {"filter_mask": bm.LAUNCHES["filter_mask"],
                "pair_mask_tiles": ix.LAUNCHES["pair_mask_tiles"],
                "pair_common": ix.LAUNCHES["pair_common"]}
    return wall, launches, k1, k4, k5b


def say_launches(what, launches, k1=None, k4=None, k5b=None):
    parts = [f"{k}={v}" for k, v in launches.items()]
    if k1 is not None and k1.calls:
        parts.append(f"K1 bounds {sorted(set(k1_bounds(k1)))}")
    if k4 is not None and k4.calls:
        parts.append("K4 mask mode planes "
                     f"{sorted({1 + (a[1] is not None) for a, _ in k4.calls})}"
                     f" start_index {sorted({a[7] for a, _ in k4.calls})}")
    if k5b is not None and k5b.calls:
        parts.append("K5b planes "
                     f"{sorted({1 + (a[1] is not None) for a, _ in k5b.calls})}")
    say(f"launches ({what}): " + ", ".join(parts))


def phase_greedy(hashes, tmp, tag, mode):
    """clust-greedy --fast --device --presketched under RTC_GREEDY_DEVICE
    ``mode`` (None: unset, the auto route), held to the native greedy on
    the same KSSD greedy order."""
    say(f"== phase {tag}: clust-greedy --fast --device --presketched, "
        f"N={len(hashes)}, RTC_GREEDY_DEVICE={mode or '(unset: auto)'}")
    from rabbittclust_tpu_torch.cli.clust_greedy import main
    from rabbittclust_tpu_torch.cluster.greedy import greedy_cluster
    from rabbittclust_tpu_torch.state import sketch_io
    from rabbittclust_tpu_torch.state.cluster_io import write_cluster_file
    from rabbittclust_tpu_torch.workflows import _greedy_corpus_is_dense
    folder = os.path.join(tmp, f"greedy_{tag}")
    p = save_presketched(hashes, folder)
    out = os.path.join(tmp, f"greedy_{tag}.cluster")
    stats = {}
    if mode:
        os.environ["RTC_GREEDY_DEVICE"] = mode
    try:
        wall, launches, k1, _, _ = run_cli(
            main, ["--fast", "--device", "--presketched", folder, "-o", out,
                   "-d", str(THRESHOLD)], stats)
    finally:
        os.environ.pop("RTC_GREEDY_DEVICE", None)
    if stats["greedy_route"] != "device":
        raise AssertionError(f"the {mode or 'auto'} route took "
                             f"{stats['greedy_route']}, not the device sweep")
    bounds = set(k1_bounds(k1))
    if launches["filter_mask"] <= 0 or bounds != {"greedy"}:
        raise AssertionError(f"K1 launches {launches['filter_mask']}, "
                             f"bounds {bounds}: expected the greedy bound")
    ss, _ = sketch_io.load_kssd_sketches(folder)
    ss2 = ss.reorder(ss.kssd_greedy_order())
    t0 = time.perf_counter()
    ref = greedy_cluster(ss2.hashes, THRESHOLD, p.kmer_size, presorted=True)
    native_s = time.perf_counter() - t0
    got = read_cluster_file(out)
    if got != ref.clusters or [c[0] for c in got] != ref.representatives:
        raise AssertionError("device greedy clusters differ from the native "
                             "engine's")
    ref_out = os.path.join(tmp, f"greedy_{tag}_native.cluster")
    write_cluster_file(ref_out, ref.clusters, ss2)
    if not same_file(out, ref_out):
        raise AssertionError("the .cluster file differs from the one "
                             "written from the native result")
    probe = dict(stats)
    if "probe_degree" not in probe:  # the forced route skips the probe
        _greedy_corpus_is_dense(ss2.hashes, THRESHOLD, p.kmer_size,
                                stats=probe)
    degree = probe.get("probe_degree")  # none below 16,384 genomes
    say(f"greedy {tag}: {len(ref.clusters)} clusters, "
        f"{len(ref.representatives)} reps = the native engine's; "
        f".cluster byte-equal")
    say(f"greedy {tag} walls (s): CLI {wall:.3f}, device route "
        f"{stats['greedy_s']:.3f} (sweep {stats['sweep_s']:.3f}, host "
        f"replay {stats['replay_s']:.3f}), native engine {native_s:.3f}; "
        f"density probe degree {degree} (cut 10)")
    say_launches(f"greedy {tag}", launches, k1)
    return launches


def save_minhash_presketched(hashes, folder, kmer_size):
    """A MinHash --presketched folder (by file, sketch size 1000); genome
    lengths vary so that the presketched length sort permutes them."""
    from rabbittclust_tpu_torch.sketch.base import SketchSet
    from rabbittclust_tpu_torch.state import sketch_io
    ss = SketchSet("minhash", None, True, True)
    for i, h in enumerate(hashes):
        length = 3_000_000 + (i * 7919) % 4001
        ss.append_genome(file_name=f"genome_{i}.fna", name=f"genome_{i}",
                         comment=f"cluster{i % N_CLUSTERS}", seq0_len=length,
                         total_len=length, num_seqs=1, hashes=h,
                         param_size=SKETCH)
    sketch_io.save_minhash_sketches(ss, folder, kmer_size, False, 0, SKETCH)


def phase_minhash(hashes, tmp):
    """9a: MinHash clust-greedy --device --presketched against the native
    parity engine; 9b: MinHash clust-mst --device --presketched against the
    native host MST."""
    say(f"== phase 9a: MinHash clust-greedy --device --presketched, "
        f"N={len(hashes)}")
    from rabbittclust_tpu_torch.cli.clust_greedy import main as greedy_main
    from rabbittclust_tpu_torch.cli.clust_mst import main as mst_main
    from rabbittclust_tpu_torch.cluster.greedy import minhash_greedy_parity
    from rabbittclust_tpu_torch.cluster.mst import compute_mst
    from rabbittclust_tpu_torch.state import sketch_io
    from rabbittclust_tpu_torch.state.cluster_io import write_cluster_file
    k = 21
    folder = os.path.join(tmp, "minhash")
    save_minhash_presketched(hashes, folder, k)
    out = os.path.join(tmp, "minhash_greedy.cluster")
    stats = {}
    os.environ.pop("RTC_GREEDY_DEVICE", None)
    wall, launches, k1, _, _ = run_cli(
        greedy_main, ["--device", "--presketched", folder, "-o", out, "-d",
                      str(THRESHOLD)], stats)
    bounds = set(k1_bounds(k1))
    if launches["filter_mask"] <= 0 or bounds != {"minhash"}:
        raise AssertionError(f"K1 launches {launches['filter_mask']}, "
                             f"bounds {bounds}: expected the minhash bound")
    ss, _ = sketch_io.load_minhash_sketches(folder)
    ss2 = ss.reorder(ss.minhash_presketched_order())
    t0 = time.perf_counter()
    ref = minhash_greedy_parity(ss2.hashes, ss2.param_sizes, THRESHOLD, k,
                                False)
    native_s = time.perf_counter() - t0
    ref_out = os.path.join(tmp, "minhash_greedy_native.cluster")
    write_cluster_file(ref_out, ref.clusters, ss2)
    if read_cluster_file(out) != ref.clusters or not same_file(out, ref_out):
        raise AssertionError("MinHash device greedy differs from the native "
                             "parity engine")
    say(f"MinHash greedy: {len(ref.clusters)} clusters = the native parity "
        f"engine's; .cluster byte-equal")
    say(f"MinHash greedy walls (s): CLI {wall:.3f}, device route "
        f"{stats['greedy_s']:.3f} (sweep {stats['sweep_s']:.3f}, host "
        f"replay {stats['replay_s']:.3f}), native parity engine "
        f"{native_s:.3f}")
    say_launches("MinHash greedy", launches, k1)

    say(f"== phase 9b: MinHash clust-mst --device --presketched, "
        f"N={len(hashes)} (dense engine, two planes)")
    out = os.path.join(tmp, "minhash_mst.cluster")
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    wall, launches9b, _, k4, k5b = run_cli(
        mst_main, ["--device", "--presketched", folder, "-o", out, "-d",
                   str(THRESHOLD)], stats)
    peak = torch.cuda.max_memory_allocated()
    planes = {1 + (a[1] is not None) for a, _ in k4.calls + k5b.calls}
    if min(launches9b["pair_mask_tiles"], launches9b["pair_common"]) <= 0 \
            or planes != {2}:
        raise AssertionError(f"launches {launches9b}, planes {planes}: "
                             "expected K4's mask mode and K5b on 2 planes")
    t0 = time.perf_counter()
    ref = compute_mst(hashes, THRESHOLD, k)
    host_s = time.perf_counter() - t0
    mst = sketch_io.load_mst(folder)
    rel = hold_mst(mst, ref.mst, len(hashes), "MinHash dense engine")
    say(f"MinHash MST: {len(mst[0])} edges, max rel weight diff {rel:.3e}, "
        f"partition at {THRESHOLD} = the host engine's")
    say("MinHash dense engine phases (s): " + ", ".join(
        f"{key}={stats[key]:.3f}" for key in (
            "pack_s", "h2d_s", "compact_s", "dispatch_s", "sweep_wait_s",
            "decode_s", "pair_common_s", "edges_s", "kruskal_s")))
    say(f"MinHash dense engine device (CUDA events): tile sweep "
        f"{stats['sweep_ms']:.3f} ms, pair-common "
        f"{stats['pair_common_ms']:.3f} ms; CLI wall {wall:.3f} s (host "
        f"engine {host_s:.3f} s); max_memory_allocated {peak} B")
    say_launches("MinHash mst", launches9b, k4=k4, k5b=k5b)
    return launches, launches9b


def hold_mst(mst, ref, n, what):
    """Phase 4's gate: same edge count, sorted weights equal to 1e-12
    relative, same partition at the threshold; returns the largest
    relative weight difference."""
    from rabbittclust_tpu_torch.cluster.mst import (
        clusters_from_forest, cut_forest)
    if len(mst[0]) != len(ref[0]):
        raise AssertionError(f"{what}: MST edges {len(mst[0])} != host "
                             f"{len(ref[0])}")
    w, w_ref = np.sort(mst[2]), np.sort(ref[2])
    rel = float(np.max(np.abs(w - w_ref) / np.maximum(np.abs(w_ref),
                                                      1e-300))) \
        if len(w) else 0.0
    if rel > 1e-12:
        raise AssertionError(f"{what}: sorted MST weights differ: max rel "
                             f"{rel}")
    if partition(clusters_from_forest(cut_forest(mst, THRESHOLD), n)) != \
            partition(clusters_from_forest(cut_forest(ref, THRESHOLD), n)):
        raise AssertionError(f"{what}: partition at the threshold differs "
                             "from the host engine's")
    return rel


def write_fasta_genomes(work, n_bases, per_base, length, seed,
                        list_name="append.list", rate=0.01):
    """``n_bases`` x ``per_base`` genomes of ``length`` bp (point mutations
    of a random base sequence at ``rate``) as one FASTA file each, genome i
    a copy of base i // per_base; returns the list file."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    os.makedirs(work)
    files = []
    for c in range(n_bases):
        base = rng.integers(0, 4, length)
        for m in range(per_base):
            seq = base.copy()
            hit = rng.random(length) < rate
            seq[hit] = rng.integers(0, 4, int(hit.sum()))
            files.append(os.path.join(work, f"a{c}_{m}.fna"))
            with open(files[-1], "wb") as f:
                f.write(f">appended_{c}_{m} base{c}\n".encode())
                f.write(acgt[seq].tobytes() + b"\n")
    lst = os.path.join(work, list_name)
    with open(lst, "w") as f:
        f.write("\n".join(files) + "\n")
    return lst


def phase_append(tmp, n_old):
    """10: clust-mst --fast --device --append over phase 4's folder."""
    say(f"== phase 10: clust-mst --fast --device --presketched --append, "
        f"N={n_old} + 1024")
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.cluster.mst import compute_mst
    from rabbittclust_tpu_torch.io.fasta import read_file_list
    from rabbittclust_tpu_torch.sketch.kssd import sketch_files_kssd
    from rabbittclust_tpu_torch.state import sketch_io
    src = os.path.join(tmp, "sketches")  # phase 4's folder, with edge.mst
    work = os.path.join(tmp, "append")
    lst = write_fasta_genomes(work, 32, 32, 100_000, SEED + 4)
    before = folder_digest(src)
    cwd = os.getcwd()
    os.chdir(work)  # the merged run folder is created here
    stats = {}
    try:
        wall, launches, _, k4, k5b = run_cli(
            main, ["--fast", "--device", "--presketched", src, "--append",
                   lst, "-l", "-o", os.path.join(work, "append.cluster"),
                   "-d", str(THRESHOLD)], stats)
    finally:
        os.chdir(cwd)
    if folder_digest(src) != before:
        raise AssertionError("--append changed its source folder")
    starts = {a[7] for a, _ in k4.calls}
    if launches["pair_mask_tiles"] <= 0 or starts != {n_old}:
        raise AssertionError(f"K4 mask-mode launches "
                             f"{launches['pair_mask_tiles']}, start_index "
                             f"{starts}: expected {n_old}")
    runs = [d for d in os.listdir(work)
            if os.path.exists(os.path.join(work, d, "edge.mst"))]
    if len(runs) != 1:
        raise AssertionError(f"expected one new run folder, found {runs}")
    ss, p = sketch_io.load_kssd_sketches(src)
    new_ss, _ = sketch_files_kssd(read_file_list(lst), 10000, p.kmer_size,
                                  p.drlevel, os.cpu_count() or 1)
    ss.extend(new_ss)
    t0 = time.perf_counter()
    ref = compute_mst(ss.hashes, THRESHOLD, p.kmer_size, start_index=n_old,
                      pre_edges=sketch_io.load_mst(src))
    host_s = time.perf_counter() - t0
    mst = sketch_io.load_mst(os.path.join(work, runs[0]))
    hold_mst(mst, ref.mst, len(ss), "append")
    say(f"append: {len(ss)} genomes ({len(new_ss)} new, ~"
        f"{int(np.mean([len(h) for h in new_ss.hashes]))} hashes each), "
        f"{len(mst[0])} MST edges = the native compute_mst(start_index="
        f"{n_old}, pre_edges); source folder unchanged")
    say(f"append walls (s): CLI {wall:.3f} (engine: pack {stats['pack_s']:.3f}"
        f", sweep waited {stats['sweep_wait_s']:.3f}, kruskal "
        f"{stats['kruskal_s']:.3f}; tiles {stats['tiles']}; device: sweep "
        f"{stats['sweep_ms']:.3f} ms, pair-common "
        f"{stats['pair_common_ms']:.3f} ms), host engine {host_s:.3f}")
    say_launches("append", launches, k4=k4, k5b=k5b)


@contextlib.contextmanager
def environment(env):
    """``os.environ`` updated by ``env`` inside the ``with`` (a None value
    removes the variable)."""
    saved = {key: os.environ.get(key) for key in env}
    for key, val in env.items():
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = val
    try:
        yield
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def run_pairs_cli(main, argv, env):
    """One clust-dbscan / clust-leiden run under the environment ``env``
    from launch and pull counts set to 0: (wall, stats, launches, K3 spy,
    seconds in ``candidate_pairs_threshold``, seconds in the leiden graph
    build, pulled bytes)."""
    from rabbittclust_tpu_torch.cluster import leiden
    from rabbittclust_tpu_torch.ops import bitmap as bm
    bm.reset_launches()
    bm.reset_pull_stats()
    stats = {}
    with environment(env), Spy(bm, "compact_masks_into") as k3, \
            Spy(bm, "candidate_pairs_threshold") as pairs, \
            Spy(leiden, "build_similarity_graph") as graph:
        t0 = time.perf_counter()
        rc = main(argv, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{argv[:3]}... returned {rc}")
    return (wall, stats, dict(bm.LAUNCHES), k3, pairs.seconds, graph.seconds,
            bm.PULL_STATS["bytes"])


def phase_dbscan(corpora, tmp):
    """11: clust-dbscan --fast --device --presketched under mask and idx,
    each .cluster byte-equal to the host path's (native pairs).  Returns
    K3's launches in the first idx run."""
    say("== phase 11: clust-dbscan --fast --device --presketched")
    from rabbittclust_tpu_torch.cli.clust_dbscan import main
    from rabbittclust_tpu_torch.cluster.dbscan import (
        dbscan_cluster, write_dbscan_result)
    from rabbittclust_tpu_torch.state import sketch_io
    k3_launches = None
    for tag, hashes, min_pts in corpora:
        folder = os.path.join(tmp, f"dbscan_{tag}")
        save_presketched(hashes, folder)
        ss, kp = sketch_io.load_kssd_sketches(folder)
        t0 = time.perf_counter()
        ref = dbscan_cluster(ss.hashes, THRESHOLD, min_pts, kp.kmer_size)
        host_s = time.perf_counter() - t0
        ref_out = os.path.join(tmp, f"dbscan_{tag}_host.cluster")
        write_dbscan_result(ref, ss, ref_out, THRESHOLD, min_pts)
        say(f"dbscan {tag}: N={len(hashes)}, minPts {min_pts}: "
            f"{ref.num_clusters} clusters, {ref.num_noise} noise points; "
            f"host path (native pairs) {host_s:.3f} s")
        for pull in ("mask", "idx"):
            out = os.path.join(tmp, f"dbscan_{tag}_{pull}.cluster")
            wall, stats, launches, k3, sweep_s, _, pulled = run_pairs_cli(
                main, ["--fast", "--device", "--presketched", folder, "-o",
                       out, "--eps", str(THRESHOLD), "--minpts",
                       str(min_pts)], {"RTC_PULL_MODE": pull})
            if not same_file(out, ref_out):
                raise AssertionError(f"dbscan {tag} ({pull}): .cluster "
                                     "differs from the host path's")
            idx = pull == "idx"
            if launches["filter_mask"] <= 0 or \
                    (launches["mask_compact"] > 0) != idx or \
                    bool(k3.calls) != idx:
                raise AssertionError(f"dbscan {tag} ({pull}): launches "
                                     f"{launches}, K3 calls {len(k3.calls)}")
            if idx and k3_launches is None:
                k3_launches = launches["mask_compact"]
            say(f"dbscan {tag} RTC_PULL_MODE={pull}: .cluster byte-equal to "
                f"the host path's; CLI wall {wall:.3f} s, dbscan "
                f"{stats['dbscan_s']:.3f} s, of it the device sweep and "
                f"exact counts {sweep_s:.3f} s; pulled {pulled} B")
            say_launches(f"dbscan {tag} {pull}", launches)
    return k3_launches


def phase_leiden(hashes, tmp):
    """12: clust-leiden --fast --device --presketched, the forced device
    route under mask and idx and the default (native) route: .cluster and
    leiden.graph byte-equal across the three."""
    say(f"== phase 12: clust-leiden --fast --device --presketched, "
        f"N={len(hashes)}")
    import shutil
    from rabbittclust_tpu_torch.cli.clust_leiden import main
    folder = os.path.join(tmp, "leiden")
    save_presketched(hashes, folder)
    outs, builds = [], {}
    for route, pull in (("force", "mask"), ("force", "idx"),
                        ("native", "auto")):
        tag = f"{route}_{pull}"
        out = os.path.join(tmp, f"leiden_{tag}.cluster")
        env = {"RTC_LEIDEN_DEVICE": "force" if route == "force" else "",
               "RTC_PULL_MODE": pull}
        wall, stats, launches, k3, _, graph_s, pulled = run_pairs_cli(
            main, ["--fast", "--device", "--presketched", folder, "-o", out,
                   "-d", str(THRESHOLD)], env)
        graph = os.path.join(tmp, f"leiden_{tag}.graph")
        shutil.copyfile(os.path.join(folder, "leiden.graph"), graph)
        idx = pull == "idx"
        if (launches["filter_mask"] > 0) != (route == "force") or \
                (launches["mask_compact"] > 0) != idx or \
                bool(k3.calls) != idx:
            raise AssertionError(f"leiden {tag}: launches {launches}")
        outs.append((tag, out, graph))
        builds[tag] = graph_s
        with open(graph) as f:
            edges = f.readline().split()[1]
        say(f"leiden {tag}: {edges} edges; CLI wall {wall:.3f} s, graph and "
            f"clustering {stats['leiden_s']:.3f} s, of it the graph build "
            f"{graph_s:.3f} s; pulled {pulled} B")
        say_launches(f"leiden {tag}", launches)
    for tag, out, graph in outs[1:]:
        if not (same_file(out, outs[0][1]) and same_file(graph, outs[0][2])):
            raise AssertionError(f"leiden {tag}: .cluster or leiden.graph "
                                 f"differs from {outs[0][0]}'s")
    n_clusters = len(read_cluster_file(outs[0][1]))
    say(f"leiden: {n_clusters} clusters; the three .cluster and leiden.graph "
        f"files byte-equal; graph build force/mask {builds['force_mask']:.3f}"
        f" s, force/idx {builds['force_idx']:.3f} s, native "
        f"{builds['native_auto']:.3f} s (force/mask at "
        f"{builds['native_auto'] / builds['force_mask']:.2f}x the native "
        "route's speed)")


# (k, drlevel) of phase 3e: 32-bit hashes, 64-bit hashes, 64-bit tuples
SKETCH_CASES = ((21, 3), (23, 3), (31, 2))


def sketch_codes(rng, k, n_pos, periodic=False):
    """One dispatch window of base codes (n_pos + k - 1, int8): random bases
    with 2 % invalid codes, or a periodic low-complexity sequence (a 3-base
    unit); a record separator (k - 1 invalid codes) every 2^20 positions."""
    n = n_pos + k - 1
    if periodic:
        w = np.resize(np.array([0, 2, 3], dtype=np.int8), n)
    else:
        w = rng.integers(0, 4, n, dtype=np.int8)
        w[rng.random(n, dtype=np.float32) < 0.02] = -1
    for at in range(1 << 20, n_pos, 1 << 20):
        w[at - (k - 1):at] = -1
    return w


def valid_windows(w, k):
    """Positions whose k codes are all valid (the table gathers K7 makes)."""
    bad = np.concatenate([[0], np.cumsum(w < 0, dtype=np.int64)])
    return int(((bad[k:] - bad[:-k]) == 0).sum())


def phase_sketch_kernel(dev, rec, card, n_pos=None):
    """3e: K7 over one full dispatch window (S x C = 16 x 2^20 positions)
    against its plain version on the card, at each of SKETCH_CASES over the
    shuffle table, and a low-complexity window over a table that keeps
    every dimension (every valid window kept: the scatter's worst case).
    Each table's keep bitmap (K7's first kernel, built once a table) is
    held to its plain version.  Each window's kernels are timed by
    ``device_ms`` (the keep pass, the scan and the scatter apart), with
    --parent in turns with the parent's K7, whose rows must be equal."""
    say("== phase 3e: K7 (kssd_sketch) against sketch_window_plain")
    from rabbittclust_tpu_torch.ops import sketch_device as sd
    from rabbittclust_tpu_torch.sketch.kssd import KssdParams, \
        get_shuffle_table
    rng = np.random.default_rng(SEED + 30)
    n_pos = n_pos or sd.S_ROWS * sd.CHUNK
    psd = PARENT.get("sd")
    cases = [(k, dr, False) for k, dr in SKETCH_CASES] + [(21, 3, True)]
    for k, dr, periodic in cases:
        p = KssdParams.from_kmer_size(k, dr)
        w = sketch_codes(rng, p.kmer_size, n_pos, periodic)
        table_np = get_shuffle_table(p.half_subk)
        if periodic:
            table_np = rng.integers(0, p.dim_end, len(table_np),
                                    dtype=np.int32)
        codes = torch.from_numpy(w).to(dev)
        table = torch.from_numpy(table_np).to(dev)
        what = (f"k {p.kmer_size} dr {dr}"
                + (" low-complexity, every dimension kept" if periodic
                   else ""))
        # the keep bitmap: built once for this table, held to its plain form
        bits, bm_ms = cuda_ms(lambda: sd._keep_bitmap_launch(table,
                                                             p.dim_end),
                              reps=5)
        want_bits, bm_plain = cuda_ms(lambda: sd.keep_bitmap_plain(
            table, p.dim_end), warmup=False)
        hold_exact(rec, "kssd_keep_bitmap", bits, want_bits, what)
        hold_exact(rec, "kssd_keep_bitmap", sd.keep_bitmap(table, p.dim_end),
                   want_bits, f"{what}, the cached one")
        b_bits = bound(4 * table.numel() + 4 * bits.numel(), 0, CORE_OPS)
        kept_dims = int(((table >= 0) & (table < p.dim_end)).sum())
        rec["kssd_keep_bitmap"]["ms"].append(bm_ms)
        rec["kssd_keep_bitmap"]["plain_ms"].append(bm_plain)
        rec["kssd_keep_bitmap"]["bound"].append(b_bits)
        say(f"K7's keep bitmap {what}: {table.numel()} dimensions, "
            f"{kept_dims} kept, {bits.numel()} words (fine and coarse): "
            f"exact; kernel {bm_ms:.4f} ms, plain {bm_plain:.3f} ms; bound "
            f"{b_bits[0]:.4f} ms ({b_bits[1]}), kernel at "
            f"{b_bits[0] / bm_ms:.3f} of it; card {card}")
        del want_bits
        got_h, got_pos = sd.sketch_window(codes, table, p)
        (want_h, want_pos), plain_ms = cuda_ms(
            lambda: sd.sketch_window_plain(codes, table, p), warmup=False)
        hold_exact(rec, "kssd_sketch", got_h, want_h, f"{what} hashes")
        hold_exact(rec, "kssd_sketch", got_pos, want_pos, f"{what} positions")
        ab = ab_times(lambda: sd.sketch_window_launch(codes, table, p),
                      psd and (lambda: psd.sketch_window_launch(codes, table,
                                                                p)))
        _, kern, call, parts = ab["change"]
        total = int(got_h.numel())
        parent = ""
        if psd:
            ph, ppos, ptot = ab["parent"][0]
            n_par = int(ptot.item())
            if n_par != total or not torch.equal(ph[:n_par], got_h) \
                    or not torch.equal(ppos[:n_par], got_pos):
                raise AssertionError(f"K7 {what}: the parent's rows differ")
            parent = (f"; the parent's K7 kernels {fmt_ms(ab['parent'][1])}"
                      f" ms, call {fmt_ms(ab['parent'][2])} ms (in turns "
                      f"parent, this, this, parent; "
                      f"{fmt_parts(ab['parent'][3])}), rows equal")
        n_valid = valid_windows(w, p.kmer_size)
        # codes read once, kept rows written once, a 32-byte sector of the
        # table for each kept window
        k7_bound = bound(len(w) + 12 * total + 32 * total, 0, CORE_OPS)
        rec["kssd_sketch"]["ms"].append(kern[0])
        rec["kssd_sketch"]["plain_ms"].append(plain_ms)
        rec["kssd_sketch"]["bound"].append(k7_bound)
        rec["kssd_sketch"].setdefault("call_ms", call[0])
        say(f"K7 {what}: {n_pos} positions, {n_valid} valid, {total} kept "
            f"({'64' if p.use64 else '32'}-bit hashes): rows and total "
            f"exact; kernels {fmt_ms(kern)} ms ({fmt_parts(parts)}), call "
            f"{fmt_ms(call)} ms{parent}; plain {plain_ms:.3f} ms; bound "
            f"{k7_bound[0]:.4f} ms ({k7_bound[1]}: {len(w)} B of codes, "
            f"{12 * total} B written, {32 * total} B of table sectors for "
            f"the kept), kernels at {k7_bound[0] / kern[0]:.4f} of it; "
            f"card {card}")
        del codes, table, got_h, got_pos, want_h, want_pos, ab, bits
        torch.cuda.empty_cache()


def planted_tokens(n, s, c, seed):
    """(n, s, c) uint32 token planes in groups of 8: a genome copies each
    sample of its group's base with its own probability in [0, 1], so
    pairs share from 0 to s samples."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 2 ** 32, size=(-(-n // 8), s, c),
                         dtype=np.uint32)
    tok = rng.integers(0, 2 ** 32, size=(n, s, c), dtype=np.uint32)
    take = rng.random((n, s)) < rng.random((n, 1))
    tok[take] = bases[np.arange(n) // 8][take]
    return tok


def phase_match_kernel(dev, rec, card, n=8192):
    """3f: K8 at N = 8,192 at the WMH and OMH shapes against its plain
    version on the card: the whole call (the id pass, then the pairs) in
    its packed form and in its int32 form, and the id pass alone against
    its plain version, each timed by ``device_ms``, K8 in turns with the
    parent's under --parent."""
    say("== phase 3f: K8 (tuple_match) against tuple_matches_plain")
    from rabbittclust_tpu_torch.ops import extra_pairs as xp
    pxp = PARENT.get("xp")
    for label, s, c in (("WMH", 50, 4), ("OMH", 64, 6)):
        tok = torch.from_numpy(planted_tokens(n, s, c, SEED + s).view(
            np.int32)).to(dev)
        ab = ab_times(lambda: xp.tuple_matches(tok),
                      pxp and (lambda: pxp.tuple_matches(tok)))
        got, k_dev, k_call, parts = ab["change"]
        want, plain_ms = cuda_ms(lambda: xp.tuple_matches_plain(tok),
                                 warmup=False)
        hold_exact(rec, "tuple_match", got, want, label)
        pack_max = xp.PACK_MAX_N
        xp.PACK_MAX_N = 0  # the int32 form
        try:
            got32, i_dev, i_call, _ = device_ms(
                lambda: xp.tuple_matches(tok))
        finally:
            xp.PACK_MAX_N = pack_max
        hold_exact(rec, "tuple_match", got32, want, f"{label} int32 form")
        ids, d_dev, d_call, d_parts = device_ms(lambda: xp.tuple_ids(tok))
        want_ids, ids_plain = cuda_ms(lambda: xp.tuple_ids_plain(tok),
                                      warmup=False)
        hold_exact(rec, "tuple_ids", ids, want_ids, f"{label} ids")
        pairs = n * (n + 1) // 2 * s
        k8_bound = bound(4 * n * n, pairs, CORE_OPS)
        jax_bound = bound(4 * n * n, n * n * s * c, CORE_OPS)
        ids_bound = bound(4 * n * s * c + 4 * n * s, n * s * c, CORE_OPS)
        for name, ms, plain, bnd, call in (
                ("tuple_match", k_dev[0], plain_ms, k8_bound, k_call[0]),
                ("tuple_ids", d_dev, ids_plain, ids_bound, d_call)):
            rec[name]["ms"].append(ms)
            rec[name]["plain_ms"].append(plain)
            rec[name]["bound"].append(bnd)
            rec[name].setdefault("call_ms", call)
        parent = ""
        if pxp:
            if not torch.equal(ab["parent"][0], got):
                raise AssertionError(f"K8 {label}: the parent's counts "
                                     "differ")
            parent = (f"; the parent's K8 kernels "
                      f"{fmt_ms(ab['parent'][1])} ms, call "
                      f"{fmt_ms(ab['parent'][2])} ms (in turns parent, "
                      f"this, this, parent; counts equal), this at "
                      f"{ab['change'][1][0] / ab['parent'][1][0]:.3f} of "
                      f"it")
        say(f"K8 {label} N={n}, {s} samples x {c} words: exact (counts "
            f"{int(want.min())}..{int(want.max())}), int32 form exact, ids "
            f"exact; kernels {fmt_ms(k_dev)} ms ({fmt_parts(parts)}), call "
            f"{fmt_ms(k_call)} ms; int32 form kernels {i_dev:.4f} ms, call "
            f"{i_call:.4f} ms; the id pass alone kernels {d_dev:.4f} ms "
            f"({fmt_parts(d_parts)}), call {d_call:.4f} ms, plain "
            f"{ids_plain:.3f} ms, bound {ids_bound[0]:.4f} ms "
            f"({ids_bound[1]}); plain K8 {plain_ms:.3f} ms; bound "
            f"{k8_bound[0]:.4f} ms ({k8_bound[1]}: {4 * n * n} B written, "
            f"{pairs} one-word compares at {CORE_OPS / 1e12:.0f} TOP/s; the "
            f"JAX formulation's {n * n * s * c} word compares "
            f"{jax_bound[0]:.4f} ms), kernels at "
            f"{k8_bound[0] / k_dev[0]:.4f} of it{parent}; card {card}")
        del tok, got, want, got32, ids, want_ids, ab
        torch.cuda.empty_cache()


def run_sketch_cli(main, argv, env, dev, cwd):
    """One CLI run from genomes in ``cwd`` under the environment ``env``,
    from K7's launch counts set to 0: (wall, stats, K7's launch counts (the
    windows' and the keep bitmap's), spy of the device sketcher)."""
    from rabbittclust_tpu_torch.ops import sketch_device as sd
    sd.reset_launches()
    stats = {}
    # the run folder is created in the working directory
    with environment(env), working_dir(cwd), \
            Spy(sd, "sketch_files_kssd_device") as spy:
        t0 = time.perf_counter()
        rc = main(argv, device=dev, stats=stats)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{argv[:3]}... returned {rc}")
    return wall, stats, dict(sd.LAUNCHES), spy


def planted_partition(n_bases, per_base, n=None):
    n = n_bases * per_base if n is None else n
    return partition([[i for i in range(n) if i // per_base == c]
                      for c in range(-(-n // per_base))])


def phase_device_sketch(tmp, dev, n_bases=32, per_base=4,
                        length=4_000_000):
    """13: the device KSSD sketcher on its path, against the native one."""
    say(f"== phase 13: RTC_DEVICE_SKETCH=1 clust-mst / clust-greedy --fast "
        f"--device -l, {n_bases * per_base} genomes of {length} bp")
    from rabbittclust_tpu_torch.cli import clust_greedy, clust_mst
    work = os.path.join(tmp, "sketch13")
    t0 = time.perf_counter()
    lst = write_fasta_genomes(work, n_bases, per_base, length, SEED + 13,
                              "genomes.list")
    with open(lst) as f:
        first16 = f.read().split()[:16]
    lst16 = os.path.join(work, "first16.list")
    with open(lst16, "w") as f:
        f.write("\n".join(first16) + "\n")
    say(f"{n_bases * per_base} FASTA files written in "
        f"{time.perf_counter() - t0:.3f} s")
    from rabbittclust_tpu_torch.io.fasta import read_fasta, read_file_list
    from rabbittclust_tpu_torch.ops.sketch_device import _encode_codes
    t0 = time.perf_counter()
    n_codes = 0
    for f in read_file_list(lst):
        for _, _, seq in read_fasta(f):
            n_codes += len(_encode_codes(seq))
    say(f"the device route's host floor: reading and encoding the "
        f"{n_codes} bases alone takes {time.perf_counter() - t0:.3f} s")
    launches = None
    # the shuffle tables are uploaded afresh, so the first device run builds
    # its keep bitmap (once, kept on the table for the runs after it)
    from rabbittclust_tpu_torch.ops.sketch_device import _device_table
    _device_table.cache_clear()
    # the 64-bit case: -k 23 would be replaced by the CLI's k tuning (k
    # above recommended + 3 = 21 at 4 Mb), so k 21 at drlevel 2 (half_k
    # 11 - drlevel 2 > 8)
    for tag, main, extra, lst_used, n in (
            ("clust-mst", clust_mst.main, [], lst, n_bases * per_base),
            ("clust-greedy", clust_greedy.main, [], lst, None),
            ("clust-mst -k 21 --drlevel 2", clust_mst.main,
             ["-k", "21", "--drlevel", "2"], lst16,
             min(16, n_bases * per_base))):
        runs = {}
        for mode in ("1", "0"):
            cwd = os.path.join(work, f"{tag.replace(' ', '_')}_{mode}")
            os.makedirs(cwd)
            out = os.path.join(cwd, "out.cluster")
            wall, stats, k7, spy = run_sketch_cli(
                main, ["--fast", "--device", "-l", "-i", lst_used, "-d",
                       str(THRESHOLD), "-o", out] + extra,
                {"RTC_DEVICE_SKETCH": mode}, dev, cwd)
            device = mode == "1"
            on_card = device and dev.type == "cuda"
            if (k7["kssd_sketch"] > 0) != on_card or \
                    bool(spy.calls) != device:
                raise AssertionError(f"{tag} RTC_DEVICE_SKETCH={mode}: K7 "
                                     f"launches {k7}, device sketcher "
                                     f"calls {len(spy.calls)}")
            if device and launches is None:
                launches = k7
                if k7["kssd_keep_bitmap"] != 1:
                    raise AssertionError(f"{tag}: the keep bitmap was built "
                                         f"{k7['kssd_keep_bitmap']} times, "
                                         "not once")
            if device:
                use64 = spy.results[0][1].use64
                if use64 != ("drlevel" in tag):
                    raise AssertionError(f"{tag}: 64-bit hashes {use64}")
            folders = [d for d in os.listdir(cwd)
                       if os.path.isdir(os.path.join(cwd, d))]
            if len(folders) != 1:
                raise AssertionError(f"{tag}: expected one run folder, "
                                     f"found {folders}")
            runs[mode] = (out, folder_digest(os.path.join(cwd, folders[0])),
                          stats["sketch_s"], wall, k7)
        if not same_file(runs["1"][0], runs["0"][0]):
            raise AssertionError(f"{tag}: .cluster differs between the "
                                 "device and the native sketcher")
        if runs["1"][1] != runs["0"][1]:
            raise AssertionError(f"{tag}: saved folders differ between the "
                                 "device and the native sketcher")
        got = partition(read_cluster_file(runs["1"][0]))
        if n is not None and got != planted_partition(n_bases, per_base, n):
            raise AssertionError(f"{tag}: partition {got} != planted")
        say(f"{tag} ({'64' if use64 else '32'}-bit hashes): .cluster and "
            f"saved folder ({len(runs['1'][1])} files) "
            f"byte-equal under both sketchers; {len(got)} clusters"
            + (" = planted" if n is not None else "")
            + f"; sketch phase device {runs['1'][2]:.3f} s (K7 launches "
            f"{runs['1'][4]}), native {runs['0'][2]:.3f} s; CLI walls "
            f"{runs['1'][3]:.3f} / {runs['0'][3]:.3f} s")
    return launches


class swapped:
    """``module.name`` is ``value`` inside the ``with``."""

    def __init__(self, module, name, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def phase_extra_sketch(tmp, dev, n_bases=32, per_base=4, length=20_000):
    """14: clust-mst --sketch-func WMH / OMH / HLL (K8 for WMH and OMH)."""
    say(f"== phase 14: clust-mst --sketch-func WMH / OMH / HLL, "
        f"{n_bases * per_base} genomes of {length} bp")
    from rabbittclust_tpu_torch import workflows_extra as wx
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.ops import extra_pairs as xp
    work = os.path.join(tmp, "extra14")
    # tests/test_extra_sketches.py's rate: at 1 % a WMH distance of 50
    # samples (~0.32 +- 0.07) can pass the 0.5 threshold within a group
    lst = write_fasta_genomes(work, n_bases, per_base, length, SEED + 14,
                              "genomes.list", rate=0.005)
    want = planted_partition(n_bases, per_base)
    launches = None
    for func, thr in (("WMH", 0.5), ("OMH", 0.2), ("HLL", 0.05)):
        out = os.path.join(work, f"{func}.cluster")
        xp.reset_launches()
        stats = {}
        with Spy(wx, "pair_distances_extra") as pairs:
            t0 = time.perf_counter()
            # WMH and OMH take the card without --device
            rc = main(["--sketch-func", func, "-l", "-i", lst, "-d",
                       str(thr), "-o", out], stats=stats,
                      device=None if dev.type == "cuda" else dev)
            wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"--sketch-func {func} returned {rc}")
        k8 = xp.LAUNCHES["tuple_match"]
        if (k8 == 1) != (func != "HLL" and dev.type == "cuda") or k8 > 1 \
                or xp.LAUNCHES["tuple_ids"] != k8:
            raise AssertionError(f"{func}: K8 launches {xp.LAUNCHES}")
        if func == "WMH":
            launches = dict(xp.LAUNCHES)
        got = partition(read_cluster_file(out))
        if got != want:
            raise AssertionError(f"{func}: partition {got} != planted")
        note = "host float64"
        if func != "HLL":
            with swapped(xp, "tuple_matches", xp.tuple_matches_plain):
                plain = wx.pair_distances_extra(pairs.calls[0][0][0], func,
                                                21, device=dev)
            if not np.array_equal(pairs.results[0], plain):
                raise AssertionError(f"{func}: K8's distance matrix differs "
                                     "from the plain version's")
            note = "K8's distance matrix = the plain version's on the card"
        say(f"{func}: {len(got)} clusters = planted; {note}; K8 launches "
            f"{k8}; CLI {wall:.3f} s: sketching {stats['sketch_s']:.3f} s, "
            f"pairs {stats['pairs_s']:.3f} s, Kruskal "
            f"{stats['kruskal_s']:.3f} s")
    return launches


def unpack_product_ms(bm, xa, xb):
    """The shared-bit product of two signature row sets alone, as one
    bfloat16 ``torch.mm`` with a float32 result (exact for 0/1 operands):
    (kernel ms, call ms) from ``device_ms``, as the kernels beside it are
    timed."""
    ua = bm.unpack_bits(xa, torch.bfloat16)
    ub = bm.unpack_bits(xb, torch.bfloat16)
    _, kern, call, _ = device_ms(
        lambda: torch.mm(ua, ub.T, out_dtype=torch.float32))
    del ua, ub
    return kern, call


def greedy_resident(hashes, dev):
    """The batched greedy's resident signatures: packed to 128 rows with
    one zero-size padding row (``_greedy_batched``'s layout)."""
    from rabbittclust_tpu_torch.ops import bitmap as bm
    xp, coll = bm.pack_bitmaps_packed(hashes, BITS, 128)
    n = len(hashes)
    if xp.shape[0] == n:
        xp = np.vstack([xp, np.zeros((1, xp.shape[1]), dtype=np.uint8)])
        coll = np.r_[coll, np.int32(0)]
    sizes = np.zeros(xp.shape[0], dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    return [torch.from_numpy(a).to(dev) for a in (xp, coll, sizes)]


def pair_bound(rows, cols, tri, out_bytes, b1_ops, extra=8):
    """The bound of a ring step or of K6 over ``rows`` x
    ``cols`` pairs: the shared-bit products it needs, two operations a bit
    multiply-add at ``b1_ops``; under the triangle (the same genomes on
    both sides, column position < row position) only the 128 x 128 blocks
    holding some j < i, as ``ring_compares`` counts them, and the
    signatures (with ``extra`` bytes a genome) read once; ``out_bytes``
    written."""
    if tri:
        nb_r, nb_c = -(-rows // 128), -(-cols // 128)
        pairs = 128 * 128 * sum(min(b + 1, nb_c) for b in range(nb_r))
        read = rows * (BITS // 8 + extra)
    else:
        pairs = rows * cols
        read = (rows + cols) * (BITS // 8 + extra)
    return bound(read + out_bytes, 2 * pairs * BITS, b1_ops)


def phase_greedy_filter_kernel(corpora, dev, rec, card, b1_ops):
    """K6 against ``greedy_filter_plain`` at the batched greedy's shapes:
    a batch of B = 2,048 genomes against R = 1,024 and 16,384 reps (the
    rep list padded with the padding row, as rep_cap pads it), the batch
    against itself (triangular), and a ragged B = 7, over the resident
    N = 32,768 signatures of phases 8a and 8b; cap 262,144 (the JAX
    route's), so a dense case runs past it.  Each case: the device time
    and the call's time over 20 calls (``device_ms``; with --parent the
    parent's K6 in turns), and one bfloat16 ``torch.mm`` of the same
    gathered 0/1 product."""
    say("== phase 3g: K6 (greedy_filter) against greedy_filter_plain")
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.ops import greedy_device as gd
    sc = bm.filter_scalars(THRESHOLD, kssd_params().kmer_size, "greedy")
    cap = max(1 << 18, 2048 * 64)
    pgd = PARENT.get("gd")
    for tag, hashes in corpora:
        x, coll, sizes = greedy_resident(hashes, dev)
        pad = x.shape[0] - 1
        batch = np.arange(N_GREEDY // 2, N_GREEDY // 2 + 2048)
        reps = {}
        for r in (1024, 16384):
            reps[r] = np.full(r, pad)
            reps[r][:r - 24] = np.arange(r - 24) * (N_GREEDY // r)
        for label, bi, ri, tri in (
                ("B=2048 R=1024", batch, reps[1024], False),
                ("B=2048 R=16384", batch, reps[16384], False),
                ("B=2048 triangular", batch, batch, True),
                ("B=7 R=1024", batch[:7], reps[1024], False)):
            args = (x, bi, ri, coll, sizes, *sc, False, cap, tri)
            t = ab_times(lambda: gd.greedy_filter(*args),
                         pgd and (lambda: pgd.greedy_filter(*args)))
            got, devs, calls, parts = t["change"]
            want, plain_ms = cuda_ms(lambda: gd.greedy_filter_plain(
                x, torch.from_numpy(bi).to(dev, torch.int32),
                torch.from_numpy(ri).to(dev, torch.int32), coll, sizes, *sc,
                False, cap, tri), warmup=False)
            what = f"{tag} {label}"
            hold_exact(rec, "greedy_filter", got, want, what)
            parent = ""
            if pgd:
                if not torch.equal(t["parent"][0], got):
                    raise AssertionError(f"K6 {what}: the parent's buffer "
                                         "differs")
                parent = (f"; the parent's K6 kernels and fills "
                          f"{fmt_ms(t['parent'][1])} ms, call {fmt_ms(t['parent'][2])} ms (in turns"
                          f" parent, this, this, parent; "
                          f"{fmt_parts(t['parent'][3])})")
            lib_ms, lib_call = unpack_product_ms(
                bm, x[torch.from_numpy(bi).to(dev)],
                x[torch.from_numpy(ri).to(dev)])
            b, r = len(bi), len(ri)
            k6_bound = pair_bound(b, r, tri, 4 * (1 + cap), b1_ops, 12)
            entry = rec["greedy_filter"]
            entry["ms"].append(devs[0])
            entry["plain_ms"].append(plain_ms)
            entry["bound"].append(k6_bound)
            entry.setdefault("call_ms", calls[0])
            entry.setdefault("library_ms", lib_ms)
            entry.setdefault("library_call_ms", lib_call)
            count = int(got[0])
            past = " (past cap)" if count > cap else ""
            say(f"K6 {what}: count {count}{past}: whole buffer exact; "
                f"kernels and memsets {fmt_ms(devs)} ms ({fmt_parts(parts)})"
                f", call {fmt_ms(calls)} ms{parent}; plain {plain_ms:.3f} "
                f"ms; bfloat16 torch.mm of the gathered product: kernel "
                f"{lib_ms:.4f} ms ({'above' if devs[0] < lib_ms else 'below'}"
                f" K6's), call {lib_call:.4f} ms "
                f"({'above' if calls[0] < lib_call else 'below'} K6's); "
                f"bound {k6_bound[0]:.4f} ms ({k6_bound[1]}), kernels at "
                f"{k6_bound[0] / devs[0]:.3f} of it; card {card}")
        del x, coll, sizes
        torch.cuda.empty_cache()


def band_shard(shard, r, rows):
    """Rows [r, r + rows) of an exact-ring shard, as a shard of its own."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    return de.PlaneShard(shard.p0[r:r + rows],
                         None if shard.p1 is None else shard.p1[r:r + rows],
                         shard.sizes[r:r + rows], shard.lo + r)


def step_live(vis, kind, row0, rows):
    """``live_blocks`` of a ring step: rows [row0, row0 + rows) of the
    local shard against all of ``vis`` (on the self step the blocks with
    some j < i)."""
    return live_blocks(origins(row0, rows), origins(0, vis.p0.shape[0]),
                       kind == "self")


def step_work(loc, vis, kind, row0=0, rows=None):
    """``join_work`` of a ring step between two one-plane shards over the
    blocks it computes: rows [row0, row0 + rows) of ``loc`` (all of them
    by default; a band of a step's rows) against all of ``vis``."""
    from rabbittclust_tpu_torch.ops.pack import compact_of
    rows = loc.p0.shape[0] if rows is None else rows
    return join_work(compact_of(loc.p0, None), row0, rows,
                     compact_of(vis.p0, None), 0, vis.p0.shape[0],
                     step_live(vis, kind, row0, rows))


def ring_compares(loc, vis, kind, row0=0, rows=None):
    """The nested loop's compares (``block_compares``) of the ring step
    ``step_work`` counts."""
    rows = loc.p0.shape[0] if rows is None else rows
    return block_compares(tuple((s.p0 >= 0).sum(1, dtype=torch.int64)
                                for s in (loc, vis)), row0,
                          rows, 0, vis.p0.shape[0],
                          step_live(vis, kind, row0, rows))


def step_bytes(loc, vis, row0=0, rows=None):
    """The compact forms a ring step reads once: rows [row0, row0 + rows)
    of ``loc`` and all of ``vis`` (values and ids, bucket offsets)."""
    from rabbittclust_tpu_torch.ops.pack import compact_of
    rows = loc.p0.shape[0] if rows is None else rows
    return compact_bytes(compact_of(loc.p0, None), row0, row0 + rows, 1) + \
        compact_bytes(compact_of(vis.p0, None), 0, vis.p0.shape[0], 1)


def ring_step_shapes(hashes, wide, mesh, cases, sc, radio, dev, rec, card):
    """The slab step's other operand shapes at 4 shards of N = 16,384, each
    step kind held to the plain step (slab and count) and timed with CUDA
    events: 64-bit hashes (``wide``, phase 9's corpus) at 8192 bits, and
    signatures of 256 bits (a short TMA box; the card tests also take 64,
    read without TMA)."""
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    n, n_dev = len(hashes), mesh.size
    for label, hs, bits in (("64-bit hashes", wide, BITS),
                            ("256-bit signatures", hashes, 256)):
        xp, coll = bm.pack_bitmaps_packed(hs, bits, pad_n_to=n_dev)
        sizes = np.array([len(h) for h in hs], dtype=np.int32)
        shards = de._bit_shards(xp, coll, sizes, mesh)
        times = []
        for case, d, t in cases:
            loc, vis = shards[d], shards[(d - t) % n_dev]
            rows = loc.xp.shape[0]
            out = torch.zeros((1, rows, rows // 8), dtype=torch.uint8,
                              device=dev)
            count = torch.zeros(1, dtype=torch.int32, device=dev)

            def step():
                count.zero_()
                de.ring_masks_step(loc, vis, t, n_dev, sc, radio, False, out,
                                   count)

            _, ms = cuda_ms(step, reps=3)
            ok = de.ring_filter_mask_plain(loc, vis, t, n_dev, sc, radio,
                                           False)
            what = f"{n_dev} shards of N={n}, {label}, {case}"
            hold_exact(rec, "ring_masks", out[0], bm.pack_mask_u8(ok), what)
            hold_exact(rec, "ring_masks", count, ok.sum(dtype=torch.int32)
                       .view(1), f"{what} count")
            times.append(f"{case} {int(count)} pairs, {ms:.4f} ms a call")
            del ok, out
        say(f"ring step {n_dev} shards of N={n}, {label} ({bits} bits): "
            f"slab and count exact on every step kind; " + "; ".join(times)
            + f"; card {card}")
        del shards
        torch.cuda.empty_cache()


def phase_ring_kernels(corpus, wide, dev, rec, card, b1_ops):
    """Each ring step kind of the exact, bitmap and mask rings (self,
    interior, antipodal on the higher shard, and the antipodal step's
    empty tile on the lower one) at 4 shards of N = 16,384 and 8 shards of
    N = 131,072, against the plain steps (the JAX ownership mask on the
    genome ids); the exact ring's plain step on a band of rows; then one
    LP round over a shard's slab with a clear list of repeated targets.
    The bitmap ring's step is the mask ring's slab step (K1, its count on
    the card) with the ring's close (counts pulled, K3, positions pulled)
    over that one step; each is timed by ``device_ms`` (device and call
    times over 20 calls), the step with its close in turns with the
    parent's step under --parent, and the whole bitmap ring at each shape
    (every step, then each shard's close) beside the parent's ring."""
    say("== phase 3h: the mesh ring steps against their plain versions "
        "(logical shards on one card)")
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.ops import labelprop as lp
    from rabbittclust_tpu_torch.ops.pack import compact_of, pack_sketches
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    sc_all = bm.filter_scalars(THRESHOLD, kssd_params().kmer_size)
    sc, radio = sc_all[:3], int(sc_all[3])
    for n, n_dev, band in ((N_GENOMES, 4, 256), (N_SLICE, 8, 128)):
        hashes = corpus[:n]
        mesh = de.make_mesh(devices=[dev] * n_dev)
        shard = n // n_dev
        band = min(band, shard)
        top = n_dev - 1
        cases = (("self", top, 0), ("interior", top, 1),
                 ("antipodal", top, n_dev // 2),
                 ("antipodal, lower shard", 0, n_dev // 2))
        xp, coll = bm.pack_bitmaps_packed(hashes, BITS, pad_n_to=n_dev)
        sizes = np.array([len(h) for h in hashes], dtype=np.int32)
        shards = de._bit_shards(xp, coll, sizes, mesh)
        del xp
        pde = PARENT.get("de")
        for label, d, t in cases:
            loc, vis = shards[d], shards[(d - t) % n_dev]
            kind = de._step_kind(t, n_dev, loc.lo, vis.lo)
            what = f"{n_dev} shards of N={n} {label} ({kind})"
            rows = loc.xp.shape[0]
            out = torch.zeros((1, rows, rows // 8), dtype=torch.uint8,
                              device=dev)
            count = torch.zeros(1, dtype=torch.int32, device=dev)
            los = [(loc.lo, vis.lo)]

            def step():
                count.zero_()  # a ring zeroes its counts once
                de.ring_masks_step(loc, vis, t, n_dev, sc, radio, False, out,
                                   count)

            def close():
                return de.ring_positions(out, count, los)

            def bitmap_step():
                step()
                return close()

            p_out = torch.zeros_like(out) if pde else None
            p_count = torch.zeros_like(count) if pde else None

            def parent_step():
                p_count.zero_()
                pde.ring_masks_step(loc, vis, t, n_dev, sc, radio, False,
                                    p_out, p_count)

            def parent_bitmap_step():
                parent_step()
                return pde.ring_positions(p_out, p_count, los)

            timed = kind != "none"
            if timed:
                sab = ab_times(step, pde and parent_step)
                _, s_dev, s_call, s_parts = sab["change"]
                _, c_dev, c_call, c_parts = ab_times(close)["change"]
                ab = ab_times(bitmap_step, pde and parent_bitmap_step)
                (ii, jj), b_dev, b_call, b_parts = ab["change"]
            else:
                ii, jj = bitmap_step()
            got = torch.from_numpy((ii - loc.lo) * rows + (jj - vis.lo)).to(
                torch.int32)
            want, plain_ms = cuda_ms(lambda: de.ring_bitmap_step_plain(
                loc, vis, t, n_dev, sc, radio, False), warmup=False)
            hold_exact(rec, "ring_bitmap", got, want.cpu(), what)
            ok, mplain_ms = cuda_ms(lambda: de.ring_filter_mask_plain(
                loc, vis, t, n_dev, sc, radio, False), warmup=False)
            hold_exact(rec, "ring_masks", out[0], bm.pack_mask_u8(ok), what)
            hold_exact(rec, "ring_masks", count, ok.sum(dtype=torch.int32)
                       .view(1), f"{what} count")
            del ok
            parent = ""
            if pde and timed:
                pi, pj = ab["parent"][0]
                if not (np.array_equal(pi, ii) and np.array_equal(pj, jj)
                        and torch.equal(p_out, out)
                        and torch.equal(p_count, count)):
                    raise AssertionError(f"ring step {what}: the parent's "
                                         "step differs")
                parent = (f"; the parent's slab step (filter_pair_kernel) "
                          f"kernels {fmt_ms(sab['parent'][1])} ms, call "
                          f"{fmt_ms(sab['parent'][2])} ms ("
                          f"{fmt_parts(sab['parent'][3])}), with its close "
                          f"kernels {fmt_ms(ab['parent'][1])} ms, call "
                          f"{fmt_ms(ab['parent'][2])} ms (each in turns "
                          f"parent, this, this, parent), slab, count and "
                          f"positions equal")
            if not timed:
                say(f"ring step {what}: empty on both: exact")
                continue
            lib_ms, lib_call = unpack_product_ms(bm, loc.xp, vis.xp)
            b_bm = pair_bound(shard, shard, kind == "self", 4 * len(ii),
                              b1_ops)
            b_mk = pair_bound(shard, shard, kind == "self",
                              shard * shard // 8, b1_ops)
            # both rings' step is the slab step (its plain version the
            # plain mask); the bitmap ring's entry also keeps its close over
            # that step
            for name in ("ring_bitmap", "ring_masks"):
                rec[name]["ms"].append(s_dev[0])
                rec[name]["plain_ms"].append(mplain_ms)
                rec[name]["bound"].append(b_mk)
                rec[name].setdefault("call_ms", s_call[0])
                rec[name].setdefault("library_ms", lib_ms)
                rec[name].setdefault("library_call_ms", lib_call)
            rec["ring_bitmap"].setdefault("close_ms", c_dev[0])
            rec["ring_bitmap"].setdefault("close_call_ms", c_call[0])
            say(f"ring step {what}: {len(ii)} candidates, slab step, count "
                f"and positions exact; the slab step (the ring step's kernel"
                f" and the count's zeroing) kernels {fmt_ms(s_dev)} ms "
                f"({fmt_parts(s_parts)})"
                f", call {fmt_ms(s_call)} ms; its close "
                f"alone (count pull, K3, positions pull and decode) kernels "
                f"{fmt_ms(c_dev)} ms, call {fmt_ms(c_call)} ms "
                f"({fmt_parts(c_parts)}); the step with its close kernels "
                f"{fmt_ms(b_dev)} ms, call {fmt_ms(b_call)} ms{parent}; "
                f"plain {plain_ms:.3f} / {mplain_ms:.3f} ms; bfloat16 "
                f"torch.mm of the product: kernel {lib_ms:.4f} ms "
                f"({'above' if s_dev[0] < lib_ms else 'below'} the step's, "
                f"{'above' if b_dev[0] < lib_ms else 'below'} the step with "
                f"its close), call {lib_call:.4f} ms "
                f"({'above' if s_call[0] < lib_call else 'below'} the "
                f"step's, {'above' if b_call[0] < lib_call else 'below'} "
                f"the step with its close); bounds {b_mk[0]:.4f} / "
                f"{b_bm[0]:.4f} ms ({b_mk[1]}; the step, the step with its "
                f"close), kernels at {b_mk[0] / s_dev[0]:.3f} / "
                f"{b_bm[0] / b_dev[0]:.3f} of them; card {card}")
        # the whole bitmap ring: every step into the slabs, then each
        # shard's close, against the parent's ring (each step's K1, its
        # count pulled and K3, then every step's positions pulled)
        launched = sum(de._step_kind(t, n_dev, d * shard,
                                     ((d - t) % n_dev) * shard) != "none"
                       for d in range(n_dev)
                       for t in range(de._n_ring_steps(n_dev)))

        close_rec = {}

        def ring_new():
            close_rec.clear()
            close_rec["compact_ms"] = []
            slabs, counts, los = de.ring_slabs(mesh, shards, sc, radio, False)
            return [de.ring_positions(slabs[d], counts[d], los[d], close_rec)
                    for d in range(n_dev)]

        def ring_parent():
            slabs, counts, los = pde.ring_slabs(mesh, shards, sc, radio,
                                                False)
            return [pde.ring_positions(slabs[d], counts[d], los[d])
                    for d in range(n_dev)]

        ab = ab_times(ring_new, pde and ring_parent, reps=3)
        parent = ""
        if pde:
            if not all(np.array_equal(a, b)
                       for pa, pb in zip(ab["parent"][0], ab["change"][0])
                       for a, b in zip(pa, pb)):
                raise AssertionError(f"the bitmap ring over {n_dev} shards "
                                     "differs from the parent's ring")
            parent = (f"; the parent's ring kernels "
                      f"{fmt_ms(ab['parent'][1])} ms, call "
                      f"{fmt_ms(ab['parent'][2])} ms ("
                      f"{fmt_parts(ab['parent'][3])})")
        say(f"bitmap ring over {n_dev} shards of N={n} ({launched} steps "
            f"launched; positions pulled and decoded to genome ids): equal "
            f"to the parent's ring where run; kernels "
            f"{fmt_ms(ab['change'][1])} ms, call "
            f"{fmt_ms(ab['change'][2])} ms a ring ("
            f"{ab['change'][1][0] / launched:.4f} / "
            f"{ab['change'][2][0] / launched:.4f} ms a launched step; "
            f"{fmt_parts(ab['change'][3])}){parent}; card {card}")
        say(f"bitmap ring over {n_dev} shards of N={n}, its last call's "
            f"closes: {fmt_close(close_rec)}")
        del ab
        if n == N_SLICE:
            # one slab of the mesh LP engine (shard 7: steps 0..4) and one
            # round of it with a clear list of repeated targets
            rng = np.random.default_rng(6)
            slab = torch.zeros((de._n_ring_steps(n_dev), shard, shard // 8),
                               dtype=torch.uint8, device=dev)
            cnt = torch.zeros(slab.shape[0], dtype=torch.int32, device=dev)
            for t in range(slab.shape[0]):
                de.ring_masks_step(shards[top], shards[(top - t) % n_dev], t,
                                   n_dev, sc, radio, False, slab[t:t + 1],
                                   cnt[t:t + 1])
            geo = torch.tensor([[top * shard] * slab.shape[0],
                                [((top - t) % n_dev) * shard
                                 for t in range(slab.shape[0])],
                                [1] * slab.shape[0]], dtype=torch.int32,
                               device=dev)
            clr = torch.from_numpy(clear_targets(slab.cpu().numpy(),
                                                 rng)).to(dev)
            planted = np.arange(n) % N_CLUSTERS
            labels = torch.from_numpy(mixed_labels(planted, rng)).to(dev)
            ref = slab.clone()
            want, plain_ms = cuda_ms(lambda: lp.round_plain(
                ref, labels, clr, *geo, shard), warmup=False)
            plp = PARENT.get("lp")
            runs = {}  # who: its round over its own copy of the slab
            for who, mod in (("this", lp), ("parent", plp)):
                if mod is None:
                    continue
                work = slab.clone()
                runs[who] = functools.partial(mod.lp_round, work, labels, clr,
                                              *geo, shard)
                got = runs[who]()
                torch.cuda.synchronize()
                hold_exact(rec, "dist_lp_round", got, want,
                           f"one slab round ({who}), fused output")
                hold_exact(rec, "dist_lp_round", work, ref,
                           f"one slab round ({who}), cleared slab")
            ab = ab_times(runs["this"], plp and runs["parent"])
            _, k_dev, k_call, parts = ab["change"]
            b_lp = bound(slab.numel() + 4 * labels.numel() + 4 * clr.numel()
                         + 4 * want.numel(), 0, CORE_OPS)
            rec["dist_lp_round"]["ms"].append(k_dev[0])
            rec["dist_lp_round"]["plain_ms"].append(plain_ms)
            rec["dist_lp_round"]["bound"].append(b_lp)
            rec["dist_lp_round"].setdefault("call_ms", k_call[0])
            live = clr[3] > 0
            parent = ""
            if plp:
                parent = (f"; the parent's round kernels "
                          f"{fmt_ms(ab['parent'][1])} ms, call "
                          f"{fmt_ms(ab['parent'][2])} ms ("
                          f"{fmt_parts(ab['parent'][3])}; in turns parent, "
                          f"this, this, parent; outputs and slab equal), "
                          f"this at {k_dev[0] / ab['parent'][1][0]:.3f} of "
                          f"it")
            say(f"LP slab round, shard {top} of 8 at N={n} ({slab.shape[0]} "
                f"steps of {shard}^2, {int(live.sum())} clear-list bits), "
                f"cross {int(want[0])}: fused output and slab exact; "
                f"kernels {fmt_ms(k_dev)} ms ({fmt_parts(parts)}), call "
                f"{fmt_ms(k_call)} ms; plain {plain_ms:.3f} ms; bound "
                f"{b_lp[0]:.4f} ms ({b_lp[1]}), kernels at "
                f"{b_lp[0] / k_dev[0]:.3f} of it{parent}; card {card}")
            del runs, ab, slab, ref, got, want
        del shards
        torch.cuda.empty_cache()
        if n == N_GENOMES:
            ring_step_shapes(hashes, wide, mesh, cases, sc, radio, dev, rec,
                             card)
        # the exact ring: planes of the shards the cases read (all four at
        # N = 16,384; shards 3, 6 and 7 at N = 131,072, whose empty case
        # reads shards 0 and 4 only for their ids), their compact forms
        # built in turns with the parent's, then each step kind against
        # the parent's step in turns
        need = sorted({d for _, d, _ in cases} | {(d - t) % n_dev
                                                  for _, d, t in cases})
        if n == N_SLICE:
            need = [3, 6, 7]
        part = [h for d in need for h in hashes[d * shard:(d + 1) * shard]]
        t0 = time.perf_counter()
        pk = pack_sketches(part, False, pad_n_to=shard)
        pack_s = time.perf_counter() - t0
        planes = {}
        for q, d in enumerate(need):
            sl = slice(q * shard, (q + 1) * shard)
            planes[d] = de.PlaneShard(
                torch.from_numpy(pk.plane0[sl].view(np.int32)).to(dev), None,
                torch.from_numpy(pk.sizes[sl].astype(np.int32)).to(dev),
                d * shard)
        del pk
        say(f"the exact ring's {n_dev} shards of N={n}: shards {need} "
            f"packed in {pack_s:.3f} s; their {len(need)} compact forms of "
            f"{shard} genomes, " + build_turns(
                [(planes[d].p0, None) for d in need]))
        for d in range(n_dev):
            if d not in planes:  # the empty case's ids only
                planes[d] = de.PlaneShard(planes[need[0]].p0, None,
                                          planes[need[0]].sizes, d * shard)
        for label, d, t in cases:
            loc, vis = planes[d], planes[(d - t) % n_dev]
            kind = de._step_kind(t, n_dev, loc.lo, vis.lo)
            what = f"{n_dev} shards of N={n} {label} ({kind})"

            def step():
                return de.ring_edges_step(loc, vis, t, n_dev, radio)

            if kind == "none":
                flat, common = step()
            else:
                ab = ab_times(step, pde and (lambda: pde.ring_edges_step(
                    loc, vis, t, n_dev, radio)),
                    reps=5 if n == N_SLICE else 10)
                (flat, common), k_dev, k_call, parts = ab["change"]
            # the plain step on the whole tile for the interior step at
            # N = 16,384 (the kernels line's case, beside the library call
            # on the same step), else on a band of rows (K4's plain form
            # takes seconds a band)
            whole = n == N_GENOMES and label == "interior"
            r, rows = (0, shard) if whole else (shard // 2 - band // 2, band)
            (pf, pc), plain_ms = cuda_ms(lambda: de.ring_edges_step_plain(
                band_shard(loc, r, rows), vis, t, n_dev, radio),
                warmup=False)
            li = flat.long() // shard
            inb = (li >= r) & (li < r + rows)
            rows_of = f"rows {r}..{r + rows - 1}"
            hold_exact(rec, "ring_edges", (flat.long()[inb] - r * shard).to(
                torch.int32), pf, f"{what} {rows_of}")
            hold_exact(rec, "ring_edges", common[inb], pc,
                       f"{what} common counts")
            if kind == "none":
                say(f"exact ring step {what}: empty on both: exact")
                continue
            work = step_work(loc, vis, kind)
            b_ex = join_bound(step_bytes(loc, vis) + 8 * flat.numel(), work)
            k4 = sum(v for key, v in parts.items()
                     if key.startswith("pair_tiles_kernel"))
            if whole:
                rec["ring_edges"]["ms"].append(k_dev[0])
                rec["ring_edges"]["plain_ms"].append(plain_ms)
                rec["ring_edges"]["bound"].append(b_ex)
                rec["ring_edges"]["call_ms"] = k_call[0]
            say(f"exact ring step {what}: {flat.numel()} pairs (K4 mask "
                f"mode, K3, K5b), {rows_of} against the plain step: exact; "
                f"kernels {fmt_ms(k_dev)} ms ({fmt_parts(parts)}), call "
                f"{fmt_ms(k_call)} ms"
                f"{parent_turns(ab, 'pairs and counts', (flat, common))}; "
                f"plain {plain_ms:.3f} ms for those rows; the join visits "
                f"{work[0]} entries and makes {work[1]} matches (the nested "
                f"loop's compares {ring_compares(loc, vis, kind)}); bound "
                f"{b_ex[0]:.4f} ms ({b_ex[1]}), kernels at "
                f"{b_ex[0] / k_dev[0]:.3f} of it, K4 alone at "
                f"{b_ex[0] / k4:.3f}; card {card}")
            if whole:
                library_call(
                    rec, {"ring_edges": k_dev[0]},
                    (compact_of(loc.p0, None), 0, shard),
                    (compact_of(vis.p0, None), 0, shard),
                    lambda dense: torch.equal(dense.flatten()[flat.long()],
                                              common),
                    f"exact ring step {what}")
        if n == N_GENOMES:
            phase_stats_kernel(planes, cases, n_dev, rec, card)
        del planes
        torch.cuda.empty_cache()


def hold_stats(rec, got, want, what):
    """A stats step (count, float32 bits of the minimum) against the plain
    step: the count equal, the minimum within 4 float32 ulp (CUDA's logf
    and torch's log may differ in the last place); ``max_abs_err`` keeps
    the largest difference of the minima."""
    entry = rec.setdefault("ring_stats", {"err": 0.0, "ms": [],
                                          "plain_ms": [], "bound": []})
    g, w = got.cpu(), want.cpu()
    ulp = abs(int(g[1]) - int(w[1]))
    low = [float(x[1:].view(torch.float32)) for x in (g, w)]
    entry["err"] = max(entry["err"], abs(low[0] - low[1]),
                       abs(int(g[0]) - int(w[0])))
    if int(g[0]) != int(w[0]) or ulp > 4:
        raise AssertionError(f"ring_stats {what}: kernel ({int(g[0])}, "
                             f"{low[0]!r}) against plain ({int(w[0])}, "
                             f"{low[1]!r}), {ulp} ulp")
    return int(g[0]), low[0], ulp


def phase_stats_kernel(planes, cases, n_dev, rec, card):
    """3i: K4's stats mode alone (the stats ring's step) at 4 shards of
    N = 16,384: each step kind over the whole 4096^2 tile, timed (with
    --parent in turns with the parent's step, outputs equal), beside its
    bound and K4's counts mode over a 4096^2 tile; the kernel held to the
    plain step on a band of 256 rows (16 tiles of 256^2 through
    ``pair_stats_tiles``, whose ``tri`` compares positions in the shard),
    both timed on that band (the kernel in turns with the parent's).  The
    interior step's band is the kernels line's case, beside the library
    call on the same band (its counts held to the plain counts)."""
    say("== phase 3i: K4's stats mode (the stats ring's steps) against the "
        "plain step")
    from rabbittclust_tpu_torch.ops import intersect as ix
    from rabbittclust_tpu_torch.ops.pack import compact_of
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    pde, pix = PARENT.get("de"), PARENT.get("ix")
    k = kssd_params().kmer_size
    radio = de.size_ratio_limit(THRESHOLD, k - 1)
    band = 256
    for label, d, t in cases:
        loc, vis = planes[d], planes[(d - t) % n_dev]
        kind = de._step_kind(t, n_dev, loc.lo, vis.lo)
        what = f"{n_dev} shards of N={N_GENOMES} {label} ({kind})"
        step_args = (loc, vis, t, n_dev, THRESHOLD, k, radio)
        shard = loc.p0.shape[0]
        r = shard // 2 - band // 2
        live = int(kind != "none")
        tiles = ([r] * (shard // band), list(range(0, shard, band)),
                 [live] * (shard // band))
        band_args = (loc.p0, loc.sizes, *tiles, radio, THRESHOLD, k, band)
        band_kw = {"cols": (vis.p0, vis.sizes), "tri": kind == "self"}
        want, plain_ms = cuda_ms(lambda: de.ring_stats_step_plain(
            band_shard(loc, r, band), *step_args[1:]), warmup=False)
        if kind == "none":
            part = ix.pair_stats_tiles(*band_args, **band_kw)
            hold_stats(rec, part, want, f"{what} rows {r}..{r + band - 1}")
            hold_stats(rec, de.ring_stats_step(*step_args), want, what)
            say(f"stats step {what}: nothing launched, empty on both: "
                "exact")
            continue
        ab = ab_times(lambda: de.ring_stats_step(*step_args), pde and (
            lambda: pde.ring_stats_step(*step_args)), reps=10)
        got, s_dev, s_call, _ = ab["change"]
        abb = ab_times(lambda: ix.pair_stats_tiles(*band_args, **band_kw),
                       pix and (lambda: pix.pair_stats_tiles(*band_args,
                                                             **band_kw)),
                       reps=10)
        part, b_dev, b_call, _ = abb["change"]
        count, low, ulp = hold_stats(rec, part, want,
                                     f"{what} rows {r}..{r + band - 1}")
        work_b = step_work(loc, vis, kind, r, band)
        work_s = step_work(loc, vis, kind)
        b_band = join_bound(step_bytes(loc, vis, r, band) + 8, work_b)
        b_step = join_bound(step_bytes(loc, vis) + 8, work_s)
        if label == "interior":  # the kernels line's case
            rec["ring_stats"]["ms"].append(b_dev[0])
            rec["ring_stats"]["plain_ms"].append(plain_ms)
            rec["ring_stats"]["bound"].append(b_band)
            rec["ring_stats"]["call_ms"] = b_call[0]
        say(f"stats step {what}: whole step {int(got[0])} pairs <= "
            f"{THRESHOLD}, min {float(got[1:].cpu().view(torch.float32))!r};"
            f" kernel {fmt_ms(s_dev)} ms, call {fmt_ms(s_call)} ms"
            f"{parent_turns(ab, 'stats', got)}; the join visits "
            f"{work_s[0]} entries and makes {work_s[1]} matches (the nested "
            f"loop's compares {ring_compares(loc, vis, kind)}); bound "
            f"{b_step[0]:.4f} ms ({b_step[1]}), at "
            f"{b_step[0] / s_dev[0]:.3f} of it; band rows {r}..{r + band - 1}:"
            f" {count} pairs, min {low!r}, {ulp} ulp from the plain step; "
            f"kernel {fmt_ms(b_dev)} ms, call {fmt_ms(b_call)} ms"
            f"{parent_turns(abb, 'stats', part)}; plain {plain_ms:.3f} ms; "
            f"the join visits {work_b[0]} entries and makes {work_b[1]} "
            f"matches (the nested loop's compares "
            f"{ring_compares(loc, vis, kind, r, band)}); bound "
            f"{b_band[0]:.5f} ms ({b_band[1]}); card {card}")
        if label == "interior":
            want_c = ix.pair_counts_plain(loc.p0[r:r + band], vis.p0)
            library_call(
                rec, {"ring_stats": b_dev[0]},
                (compact_of(loc.p0, None), r, band),
                (compact_of(vis.p0, None), 0, shard),
                lambda dense: torch.equal(dense, want_c),
                f"stats step {what} rows {r}..{r + band - 1}")
            del want_c
        if kind == "self":
            _, c_ms = cuda_ms(lambda: ix.pair_counts_tiles(
                loc.p0, None, [0], [0], [1], shard), reps=3)
            say(f"K4 counts mode over the shard's own 4096^2 tile (it "
                f"takes no second form): {c_ms:.3f} ms beside the stats "
                f"mode's full steps; card {card}")


def phase_mesh(corpus, want, dev, tmp):
    """The mesh ring engines over logical shards on the card: (a)
    ``RTC_MESH=1 clust-mst`` (one visible card: a 1-shard exact ring)
    against phase 4's dense-engine files, (b) ``distributed_mst`` exact and
    bitmap over 4 shards, (c) the mesh LP engine over 8 shards at
    N = 131,072, (d) the bitmap ring's threshold clusters and similarity
    graph over 4 shards."""
    say("== phase 15: the mesh ring engines (N logical shards on one card; "
        "no multi-GPU time is claimed from them)")
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.cluster.leiden import build_similarity_graph
    from rabbittclust_tpu_torch.cluster.mst import (clusters_from_forest,
                                                    cut_forest)
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    from rabbittclust_tpu_torch.state import sketch_io
    k = kssd_params().kmer_size
    hashes = corpus[:N_GENOMES]
    n = len(hashes)
    launches = {}

    folder = os.path.join(tmp, "mesh_sketches")
    save_presketched(hashes, folder)
    out = os.path.join(tmp, "mesh.cluster")
    os.environ["RTC_MESH"] = "1"
    de.reset_launches()
    try:
        t0 = time.perf_counter()
        rc = main(["--fast", "--device", "--presketched", folder, "-o", out,
                   "-d", str(THRESHOLD)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["RTC_MESH"]
    if rc != 0:
        raise RuntimeError(f"RTC_MESH=1 clust-mst returned {rc}")
    la = dict(de.LAUNCHES)
    if la["ring_edges"] != 1:
        raise AssertionError(f"the 1-shard exact ring launched {la}")
    dense_folder = os.path.join(tmp, "sketches")
    if not (same_file(out, os.path.join(tmp, "slice.cluster")) and
            same_file(os.path.join(folder, "edge.mst"),
                      os.path.join(dense_folder, "edge.mst"))):
        raise AssertionError("RTC_MESH=1: edge.mst or .cluster differs from "
                             "phase 4's dense-engine run")
    say(f"15a RTC_MESH=1 clust-mst --fast --device --presketched, N={n}: a "
        f"1-shard exact ring, edge.mst and .cluster byte-equal to phase 4's"
        f" dense engine; wall {wall:.3f} s; launches {la}")

    mesh4 = de.make_mesh(devices=[dev] * 4)
    dense_mst = sketch_io.load_mst(dense_folder)
    for engine in ("exact", "bitmap"):
        de.reset_launches()
        k3 = bm.LAUNCHES["mask_compact"]
        t0 = time.perf_counter()
        with recorded_closes(de) as closes:
            res = de.distributed_mst(hashes, THRESHOLD, k, mesh=mesh4,
                                     engine=engine)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # each ring launches its step's kernels a step (the exact ring's K3
        # among them); the bitmap ring then K3 once a shard at its close
        key = "ring_edges" if engine == "exact" else "ring_bitmap"
        launches[key] = de.LAUNCHES[key]
        if launches[key] != 10:
            raise AssertionError(f"{engine} ring over 4 shards: "
                                 f"{launches[key]} step launches, not 10")
        k3 = bm.LAUNCHES["mask_compact"] - k3
        if engine == "bitmap" and k3 != 4:
            raise AssertionError(f"bitmap ring over 4 shards: {k3} closing "
                                 "K3 launches, not one a shard")
        got = partition(clusters_from_forest(cut_forest(res.mst, THRESHOLD),
                                             n))
        if got != want:
            raise AssertionError(f"{engine} ring: partition differs")
        same = engine == "bitmap" or all(
            np.array_equal(a, b) for a, b in zip(res.mst, dense_mst))
        if not same:
            raise AssertionError("exact ring: MST differs from the dense "
                                 "engine's edge.mst")
        say(f"15b distributed_mst engine={engine} over [cuda:0] * 4, N={n}:"
            f" {len(res.mst[0])} MST edges"
            f"{' = the dense engine edge.mst' if engine == 'exact' else ''}"
            f", partition at {THRESHOLD} = phase 4's; {secs:.3f} s (4 "
            f"logical shards on one card); launches {dict(de.LAUNCHES)}, "
            f"K3 {k3}")
        if engine == "bitmap":
            say(f"15b the bitmap ring's closes: {fmt_close(closes)}")
    # the copies a mesh of distinct cards would make, which logical shards
    # on one card do not (the dist_engine module's analytic volume)
    say(f"15b a bitmap ring over 4 distinct cards would move per device "
        f"{de.ring_comm_stats(-(-n // 4) * 4, 4, BITS // 8)} (analytic, "
        "not measured: the logical shards share one card)")

    mesh8 = de.make_mesh(devices=[dev] * 8)
    de.reset_launches()
    t0 = time.perf_counter()
    got = de.distributed_threshold_clusters_lp(corpus, THRESHOLD, k,
                                               mesh=mesh8)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches["ring_masks"] = de.LAUNCHES["ring_masks"]
    launches["dist_lp_round"] = de.LAUNCHES["dist_lp_round"]
    planted = partition([list(range(c, len(corpus), N_CLUSTERS))
                         for c in range(N_CLUSTERS)])
    if partition(got) != planted:
        raise AssertionError(f"mesh LP: {len(got)} clusters, not the "
                             f"{N_CLUSTERS} planted ones")
    st = de.DIST_LP_LAST
    say(f"15c distributed_threshold_clusters_lp over [cuda:0] * 8, "
        f"N={len(corpus)}: the {N_CLUSTERS} planted clusters in {secs:.3f} s"
        f" (8 logical shards on one card): build {st['build_ms']:.3f} ms, "
        f"{st['rounds']} rounds, per-round ms "
        f"{[round(x, 4) for x in st['round_ms']]}, host rounds "
        f"{st['rounds_s']:.3f} s; step launches {launches['ring_masks']}, "
        f"slab rounds {launches['dist_lp_round']}")
    comm = de.dist_lp_comm_stats(st["n_pad"], st["n_dev"], st["bits"],
                                 st["rounds"])
    say(f"15c over 8 distinct cards it would move per device {comm} "
        "(analytic, not measured)")

    de.reset_launches()
    k3 = bm.LAUNCHES["mask_compact"]
    t0 = time.perf_counter()
    tc = de.distributed_threshold_clusters(hashes, THRESHOLD, k, mesh=mesh4)
    tc_s = time.perf_counter() - t0
    if partition(tc) != want:
        raise AssertionError("distributed_threshold_clusters: partition "
                             "differs from phase 4's")
    t0 = time.perf_counter()
    with recorded_closes(de) as closes:
        frm, to, w = de.distributed_similarity_graph(hashes, THRESHOLD, k,
                                                     mesh=mesh4)
    g_s = time.perf_counter() - t0
    hf, ht, hw = build_similarity_graph(hashes, THRESHOLD, k)

    def edge_order(f, t, wt):
        f, t, wt = (np.asarray(x) for x in (f, t, wt))
        o = np.lexsort((wt, t, f))
        return f[o], t[o], wt[o]

    if len(frm) != len(hf) or not all(
            np.array_equal(a, b) for a, b in zip(edge_order(frm, to, w),
                                                 edge_order(hf, ht, hw))):
        raise AssertionError("distributed_similarity_graph: edges differ "
                             "from build_similarity_graph's")
    say(f"15d over [cuda:0] * 4, N={n}: distributed_threshold_clusters = "
        f"phase 4's partition ({tc_s:.3f} s), distributed_similarity_graph "
        f"= build_similarity_graph's {len(frm)} edges and weights "
        f"({g_s:.3f} s); bitmap ring steps {de.LAUNCHES['ring_bitmap']}, "
        f"closing K3s {bm.LAUNCHES['mask_compact'] - k3}; the last ring's "
        f"closes: {fmt_close(closes)}")
    say("launches (phase 15): " + ", ".join(
        f"{k_}={v}" for k_, v in launches.items()))
    return launches


def batched_oracle(hashes, kmer_size):
    """The copied ``greedy_cluster_batched`` (a Python inverted index), run
    in a worker process while the card runs the earlier phases."""
    from rabbittclust_tpu_torch.cluster.greedy import greedy_cluster_batched
    t0 = time.perf_counter()
    res = greedy_cluster_batched(hashes, THRESHOLD, kmer_size,
                                 batch_size=2048)
    return res.clusters, res.representatives, time.perf_counter() - t0


def phase_batched_greedy(corpora, oracles, dev):
    """``greedy_cluster_device(conflict="batched", batch_size=2048)`` at
    N = 32,768 on phases 8a's and 8b's corpora, equal to the copied
    ``greedy_cluster_batched``."""
    say("== phase 16: the batched greedy (K6) at N=32,768")
    from rabbittclust_tpu_torch.ops import greedy_device as gd
    k = kssd_params().kmer_size
    launches = 0
    for (tag, hashes), oracle in zip(corpora, oracles):
        gd.reset_launches()
        stats = {}
        t0 = time.perf_counter()
        res = gd.greedy_cluster_device(hashes, THRESHOLD, k,
                                       batch_size=2048, conflict="batched",
                                       device=dev, stats=stats)
        secs = time.perf_counter() - t0
        n_k6 = gd.LAUNCHES["greedy_filter"]
        clusters, reps, host_s = oracle.get()
        if res.clusters != clusters or res.representatives != reps:
            raise AssertionError(f"batched greedy {tag}: differs from "
                                 "greedy_cluster_batched")
        if n_k6 < -(-(len(hashes) - 1) // 2048):
            raise AssertionError(f"batched greedy {tag}: {n_k6} K6 launches")
        launches = launches or n_k6
        say(f"16 {tag}: {len(reps)} reps, {len(clusters)} clusters = "
            f"greedy_cluster_batched's; {secs:.3f} s (device sweep "
            f"{stats['sweep_s']:.3f} s, host {stats['replay_s']:.3f} s), "
            f"the Python oracle {host_s:.3f} s (in a worker process)")
        say(f"launches (phase 16 {tag}): greedy_filter={n_k6}")
    return launches


def mesh_child(pid, port, corpus_path, out_path, device="cuda:0"):
    """One of phase 17(a)'s two processes: 2 shards on cuda:0, this
    process's ``shard_bounds`` block of the corpus, the threshold clusters
    and the MST over the multi-process ring; its results and times go to
    ``out_path``."""
    import pickle
    from rabbittclust_tpu_torch.cluster.mst import cut_forest
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    from rabbittclust_tpu_torch.parallel import multihost as mh
    t_start = time.perf_counter()
    dev = torch.device(device)
    mesh = mh.init_multihost(f"127.0.0.1:{port}", 2, pid, [dev] * 2)
    z = np.load(corpus_path)
    flat, offs = z["flat"], z["offs"]
    n = len(offs) - 1
    lo, hi = mh.shard_bounds(n, 2, pid)
    block = [flat[offs[g]:offs[g + 1]] for g in range(lo, hi)]
    k = kssd_params().kmer_size
    de.reset_launches()
    bm.reset_launches()
    out = {"pid": pid, "transport": mesh.transport, "rings": []}
    t0 = time.perf_counter()
    out["clusters"] = mh.multihost_threshold_clusters(block, n, THRESHOLD, k)
    out["clusters_s"] = time.perf_counter() - t0
    out["rings"].append(dict(mh.RING_LAST))
    t0 = time.perf_counter()
    res = mh.multihost_mst(block, n, THRESHOLD, k)
    out["mst_s"] = time.perf_counter() - t0
    out["rings"].append(dict(mh.RING_LAST))
    out["cut"] = [a.tolist() for a in cut_forest(res.mst, THRESHOLD)]
    out["launches"] = dict(de.LAUNCHES, closes=bm.LAUNCHES["mask_compact"])
    out["wall"] = time.perf_counter() - t_start
    mh.shutdown_multihost()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def phase_seconds(err, what):
    """Each ``-----process i: <what> X s`` line of a rank's stderr."""
    return [float(m.group(1)) for m in re.finditer(
        rf"-----process \d+: {what} ([0-9.]+) s", err)]


def phase_multiprocess(hashes, want, host_mst, dense_mst, dev, tmp, card,
                       rec):
    """17: the multi-process mesh (``parallel/multihost.py``) on the one
    card: (a) 2 processes x 2 shards on cuda:0 over phase 4's corpus, each
    passing its block: the threshold clusters against phase 4's host
    partition; the MST cut edge for edge against the native host MST's,
    its weights to phase 4's 1e-12 relative (the native library computes
    distances in C++, whose log may differ from NumPy's in the last
    place), and byte for byte against phase 4's dense-engine MST (NumPy
    float64 distances, as the multi-process engine's); the ring's steps
    and hops per process; (b)
    ``clust-mst`` and ``clust-greedy --multihost`` with 2 processes over
    phase 13's FASTA list through ``parallel/launch.py``, byte-equal to
    the single-process ``--device -t 2`` runs (the MST cut's member order;
    with ``-e`` the single process takes the MST-free engine, whose
    forest orders members otherwise); (c) the port's dry run
    over ``[cuda:0] * 4`` (the stats ring, held to the plain steps over
    CPU shards at the same shapes, then its own 2-process simulation)."""
    say("== phase 17: the multi-process mesh on the one card (ranks share "
        "it: the ring's hop goes through host memory over gloo; no "
        "multi-GPU time is claimed)")
    import pickle
    from rabbittclust_tpu_torch.cli import clust_greedy, clust_mst
    from rabbittclust_tpu_torch.cluster.mst import cut_forest
    from rabbittclust_tpu_torch.ops.pack import pack_sketches
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    from rabbittclust_tpu_torch.parallel import launch as pl
    from rabbittclust_tpu_torch.parallel.dryrun import (dryrun_corpus,
                                                        dryrun_multichip)
    from rabbittclust_tpu_torch.parallel.multihost import free_port, run_ranks
    torch.cuda.empty_cache()
    launches = {}
    # (a)
    work = os.path.join(tmp, "mesh17")
    os.makedirs(work)
    corpus_path = os.path.join(work, "corpus.npz")
    offs = np.zeros(len(hashes) + 1, dtype=np.int64)
    np.cumsum([len(h) for h in hashes], out=offs[1:])
    np.savez(corpus_path, flat=np.concatenate(hashes), offs=offs)
    port = free_port()
    outs = [os.path.join(work, f"proc{pid}.pkl") for pid in range(2)]
    t0 = time.perf_counter()
    rcs, _, errs = run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--mesh-child",
          str(pid), str(port), corpus_path, outs[pid], str(dev)]
         for pid in range(2)], timeout=600, cwd=ROOT)
    wall = time.perf_counter() - t0
    if rcs != [0, 0]:
        raise RuntimeError(f"17a: the processes returned {rcs}:\n"
                           + "\n".join(e[-3000:] for e in errs))
    res = []
    for path in outs:
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    host_cut = cut_forest(host_mst, THRESHOLD)
    dense_cut = [a.tolist() for a in cut_forest(dense_mst, THRESHOLD)]
    n = len(hashes)
    for r in res:
        if partition(r["clusters"]) != want:
            raise AssertionError(f"17a process {r['pid']}: threshold "
                                 "clusters differ from phase 4's host "
                                 "partition")
        w, w_host = np.asarray(r["cut"][2]), host_cut[2]
        rel = float(np.max(np.abs(w - w_host) / np.maximum(
            np.abs(w_host), 1e-300))) if len(w) == len(w_host) and len(w) \
            else 0.0
        if r["cut"][:2] != [a.tolist() for a in host_cut[:2]] or \
                len(w) != len(w_host) or rel > 1e-12:
            raise AssertionError(f"17a process {r['pid']}: the MST cut at "
                                 f"{THRESHOLD} differs from the host MST's "
                                 f"(weights up to {rel:.3e} relative)")
        if r["cut"] != dense_cut:
            raise AssertionError(f"17a process {r['pid']}: the MST cut "
                                 "differs from phase 4's dense engine's")
        if r["launches"]["ring_bitmap"] <= 0 or r["launches"]["closes"] <= 0:
            raise AssertionError(f"17a process {r['pid']}: no K9b step or "
                                 f"close launched ({r['launches']})")
        ring = r["rings"][0]
        say(f"17a process {r['pid']}/2 (2 shards on cuda:0, transport "
            f"{r['transport']}): threshold clusters = phase 4's partition "
            f"({r['clusters_s']:.3f} s), MST cut = the native host MST's "
            f"edge for edge (weights within {rel:.3e} relative) and = the "
            f"dense engine's byte for byte ({len(r['cut'][0])} edges; "
            f"{r['mst_s']:.3f} s); K9b steps "
            f"{r['launches']['ring_bitmap']}, ms "
            f"{[round(x, 4) for x in ring['step_ms']]}, closes (one K3 a "
            f"shard) {r['launches']['closes']}, ms (pulls and K3) "
            f"{[round(x, 4) for x in ring['compact_ms']]}; hops "
            f"{ring['hop_bytes']} B in "
            f"{[round(x, 3) for x in ring['hop_ms']]} ms "
            f"({[round(b / ms / 1e6, 3) for b, ms in zip(ring['hop_bytes'], ring['hop_ms'])]}"
            f" GB/s); process wall {r['wall']:.3f} s; card {card}")
    say(f"17a N={n}: both processes' partition and MST cut equal to the "
        f"host engine's; wall of the two processes {wall:.3f} s; a bitmap "
        f"ring over 4 distinct cards would move per device "
        f"{de.ring_comm_stats(n, 4, BITS // 8)} (analytic: the sizes, ids "
        "and collisions of JAX's hop; the port's hop sends sizes, "
        "collisions and the first id)")
    launches["ring_bitmap_multiprocess"] = res[0]["launches"]["ring_bitmap"]
    # (b)
    lst = os.path.join(tmp, "sketch13", "genomes.list")
    for module, main in (("mst", clust_mst.main),
                         ("greedy", clust_greedy.main)):
        single = os.path.join(work, f"single_{module}.cluster")
        multi = os.path.join(work, f"multi_{module}.cluster")
        back = os.getcwd()
        os.chdir(work)  # the single-process run saves its folder here
        try:
            t0 = time.perf_counter()
            rc = main(["--fast", "--device", "-l", "-i", lst, "-o", single,
                       "-d", str(THRESHOLD), "-t", "2"], device=dev)
            single_s = time.perf_counter() - t0
        finally:
            os.chdir(back)
        if rc != 0:
            raise RuntimeError(f"17b single-process clust-{module} failed")
        t0 = time.perf_counter()
        errs = []
        rc = pl.launch(2, ["--fast", "-l", "-i", lst, "-o", multi, "-d",
                           str(THRESHOLD), "-t", "4"], module=module,
                       timeout=600, errs=errs)
        multi_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"17b clust-{module} --multihost returned "
                               f"{rc}")
        if not same_file(single, multi):
            raise AssertionError(f"17b clust-{module} --multihost: .cluster"
                                 " differs from the single-process run")
        ingest = [phase_seconds(e, "ingest\\+sketch\\+allgather")
                  for e in errs]
        phase = [phase_seconds(e, f"distributed {module} cluster phase")
                 for e in errs]
        say(f"17b clust-{module} --multihost, 2 processes on cuda:0, 128 "
            f"genomes of 4 Mb (64 each): .cluster byte-equal to the "
            f"single-process --device -t 2 run; per process ingest "
            f"{ingest} s, cluster phase {phase} s; wall {multi_s:.3f} s "
            f"(single process {single_s:.3f} s)")
    # (c)
    de.reset_launches()
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, devices=[dev] * 4)
    dry_s = time.perf_counter() - t0
    launches["ring_stats"] = de.LAUNCHES["ring_stats"]
    if launches["ring_stats"] <= 0:
        raise AssertionError("17c: the dry run launched no stats step")
    # the stats ring at the dry run's own shapes against the plain steps
    # over CPU shards: the count equal, the minimum within 4 float32 ulp
    hashes_dry = dryrun_corpus(4)
    n_dry = len(hashes_dry)
    pk_dry = pack_sketches(hashes_dry, use64=False, pad_n_to=n_dry)
    plain = de.distributed_candidate_stats(
        pk_dry.plane0[:n_dry], pk_dry.sizes[:n_dry], threshold=0.05,
        kmer_size=20, mesh=de.make_mesh(4, devices=[torch.device("cpu")] * 4))
    ulp = abs(int(np.float32(dry["min_d"]).view(np.int32))
              - int(np.float32(plain[1]).view(np.int32)))
    if dry["total"] != plain[0] or ulp > 4:
        raise AssertionError(f"17c: the stats ring ({dry['total']}, "
                             f"{dry['min_d']!r}) against the plain steps "
                             f"({plain[0]}, {plain[1]!r}), {ulp} ulp")
    entry = rec["ring_stats"]
    entry["err"] = max(entry["err"], abs(dry["min_d"] - plain[1]))
    say(f"17c dryrun_multichip(4) over [cuda:0] * 4: {dry['total']} pairs "
        f"<= 0.05, min {dry['min_d']!r} (the plain steps over CPU shards: "
        f"{plain[0]}, {plain[1]!r}, {ulp} ulp); stats steps launched "
        f"{launches['ring_stats']}; its simulation {dry['sim']}; "
        f"{dry_s:.3f} s")
    say("launches (phase 17): " + ", ".join(
        f"{k_}={v}" for k_, v in launches.items()))
    return {"ring_stats": launches["ring_stats"]}


def cluster_groups(path):
    """The genome file names of each cluster of a by-file ``.cluster`` file
    (``a<group>_<copy>.fna``, ``write_fasta_genomes``' names)."""
    clusters = []
    with open(path) as f:
        for line in f:
            if line.startswith("the cluster"):
                clusters.append([])
            elif line.startswith("\t"):
                clusters[-1].append(os.path.basename(
                    line.split("\t")[4].strip()))
    return clusters


def hold_groups(path, files, what):
    """The clusters of ``path`` are the planted groups of ``files``; a file
    the writer left out (a representative created by the incremental pass
    is not a member of its own cluster) is put back into its group's
    cluster first.  Returns how many were put back."""
    clusters = cluster_groups(path)
    names = [os.path.basename(f) for f in files]
    printed = [n for cl in clusters for n in cl]
    missing = sorted(set(names) - set(printed))
    if len(printed) != len(set(printed)) or set(printed) - set(names):
        raise AssertionError(f"{what}: members repeated or unknown")
    groups = [{n.split("_")[0] for n in cl} for cl in clusters]
    for n in missing:
        home = [cl for cl, g in zip(clusters, groups)
                if g == {n.split("_")[0]}]
        if len(home) != 1:
            raise AssertionError(f"{what}: {n} has no cluster of its group")
        home[0].append(n)
    want = sorted(sorted(n for n in names if n.split("_")[0] == g)
                  for g in {n.split("_")[0] for n in names})
    if sorted(sorted(cl) for cl in clusters) != want:
        raise AssertionError(f"{what}: clusters are not the planted groups")
    return len(missing)


@contextlib.contextmanager
def working_dir(path):
    """Run the ``with`` body from ``path`` (made if missing): the CLIs
    make their run folders in the working directory."""
    os.makedirs(path, exist_ok=True)
    back = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(back)


def run_card_cli(main, argv, cwd):
    """``run_cli`` from ``cwd``: (wall, launches, K4 mask-mode spy)."""
    with working_dir(cwd):
        wall, launches, _, k4, _ = run_cli(main, argv, {})
    return wall, launches, k4


def repdb_probe(st, queries, dev, pull):
    """``batch_query_device`` under ``RTC_PULL_MODE=pull`` from launch
    counts set to 0: (hits, wall, launches, K1 tiles, seconds in the
    candidate generator)."""
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.state.greedy_state import batch_query_device
    os.environ["RTC_PULL_MODE"] = pull
    bm.reset_launches()
    try:
        with Spy(bm, "candidate_pairs_threshold") as cand, \
                Spy(bm, "batched_mask") as k1:
            t0 = time.perf_counter()
            hits = batch_query_device(st, queries, 3, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        os.environ.pop("RTC_PULL_MODE", None)
    tiles = sum(int(np.count_nonzero(a[5])) for a, _ in k1.calls)
    return hits, wall, dict(bm.LAUNCHES), tiles, cand.seconds


def phase_state_repdb(tmp, dev, card):
    """18: the state files and RepDB on the card: (a) the greedy RepDB of
    phase 8a's corpus and its device probe at 4,096 queries against the
    serial loops; (b) the RepDB CLIs over phase 13's genomes; (c) each
    --save-rep / --append arm; (d) the RepDB serving path with two
    ranks on cuda:0."""
    say("== phase 18: the state files and RepDB on the card")
    from rabbittclust_tpu_torch.cli import clust_greedy, clust_mst
    from rabbittclust_tpu_torch.cli.repdb import write_query_tsv
    from rabbittclust_tpu_torch.cluster.mst import (clusters_from_forest,
                                                    compute_mst, cut_forest)
    from rabbittclust_tpu_torch.io.fasta import read_file_list
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.parallel import launch as pl
    from rabbittclust_tpu_torch.sketch.kssd import sketch_files_kssd
    from rabbittclust_tpu_torch.sketch.minhash import sketch_files_minhash
    from rabbittclust_tpu_torch.state import sketch_io
    from rabbittclust_tpu_torch.state.greedy_state import KssdClusterState
    from rabbittclust_tpu_torch.state.mst_state import MstState
    work = os.path.join(tmp, "state18")
    launches = {}
    # (a) the RepDB of phase 8a's sparse corpus, N = 32,768
    db = os.path.join(work, "a", "rep.db")
    wall, _, _ = run_card_cli(
        clust_greedy.main, ["--fast", "--device", "--db", db, "--build",
                            "--presketched", os.path.join(tmp, "greedy_8a"),
                            "-o", os.path.join(work, "a", "build.cluster"),
                            "-d", str(THRESHOLD)], os.path.join(work, "a"))
    t0 = time.perf_counter()
    st = KssdClusterState.load_repdb(db)
    load_s = time.perf_counter() - t0
    n_reps = len(st.representative_ids)
    say(f"18a --db --build --presketched (phase 8a's {len(st.hashes)} "
        f"genomes): {n_reps} representatives, {len(st.inverted_index)} "
        f"indexed hashes, REPDB002 {os.path.getsize(db)} B; CLI {wall:.3f} "
        f"s, load_repdb {load_s:.3f} s")
    rng = np.random.default_rng(SEED)
    reps = [st.hashes[g] for g in st.representative_ids]
    planted = [reps[r][rng.random(len(reps[r])) < 0.8]
               for r in rng.choice(n_reps, 3072, replace=False)]
    novel = [np.unique(rng.integers(0, 2 ** 31, SKETCH).astype(np.uint32))
             for _ in range(1024)]
    queries = planted + novel
    t0 = time.perf_counter()
    want = [st.query_topk(q, 3) for q in queries]
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_assign = [st.assign(q) for q in queries]
    serial_assign_s = time.perf_counter() - t0
    if serial_s > 60:
        raise AssertionError(f"18a: the serial loop took {serial_s:.1f} s")
    for pull in ("mask", "idx"):
        hits, wall, got_l, tiles, cand_s = repdb_probe(st, queries, dev,
                                                       pull)
        if hits != want:
            raise AssertionError(f"18a ({pull}): the device probe differs "
                                 "from the serial query_topk loop")
        if got_l["filter_mask"] <= 0 or \
                (got_l["mask_compact"] > 0) != (pull == "idx"):
            raise AssertionError(f"18a ({pull}): launches {got_l}")
        # the assignment from the probe's best hit (state.assign's rule)
        assign = [h[0] if h and h[0]["distance"] <= st.threshold else
                  {"rep_idx": -1, "genome_id": -1,
                   "genome_name": "unassigned", "distance": -1.0,
                   "cluster_id": -1, "cluster_size": 0} for h in hits]
        if assign != want_assign:
            raise AssertionError(f"18a ({pull}): the probe's assignment "
                                 "differs from the serial assign loop")
        if pull == "mask":
            launches["filter_mask"] = got_l["filter_mask"]
        else:
            launches["mask_compact"] = got_l["mask_compact"]
        say(f"18a batch_query_device RTC_PULL_MODE={pull}, {len(queries)} "
            f"queries ({len(planted)} from representatives, keep 0.8; "
            f"{len(novel)} novel) against {n_reps} representatives: hits "
            f"= the serial query_topk loop field for field, assignment = "
            f"the serial assign loop; wall {wall:.3f} s (candidates "
            f"{cand_s:.3f} s, host re-scoring {wall - cand_s:.3f} s); "
            f"K1 launches {got_l['filter_mask']} over {tiles} tiles, K3 "
            f"launches {got_l['mask_compact']}")
    combined = reps + queries
    _, k1_ms, call_ms, parts = device_ms(
        lambda: bm.candidate_pairs_threshold(
            combined, st.threshold, st.kmer_size, return_shared=True,
            device=dev), reps=1)
    k1_kern = sum(v for k_, v in parts.items() if "filter" in k_)
    say(f"18a the probe's candidates (mask pull): K1 kernels {k1_kern:.3f} "
        f"ms, all kernels {k1_ms:.3f} ms, call {call_ms:.3f} ms; serial "
        f"query_topk loop {serial_s:.3f} s, assign loop "
        f"{serial_assign_s:.3f} s; card {card}")
    del st, reps, combined
    # (b) the RepDB CLIs over phase 13's genomes: copies 0-1 build, 2-3 query
    src13 = os.path.join(tmp, "sketch13")
    files = {m: [os.path.join(src13, f"a{c}_{m}.fna") for c in range(32)]
             for m in range(4)}
    lists = {}
    for name, ms in (("build", (0, 1)), ("query", (2, 3))):
        lists[name] = os.path.join(work, f"{name}.list")
        with open(lists[name], "w") as f:
            f.write("\n".join(files[m][c] for c in range(32) for m in ms)
                    + "\n")
    wb = os.path.join(work, "b")
    g = ["--fast", "--db", os.path.join(wb, "g.db"), "-d", str(THRESHOLD)]
    q = ["-l", "-i", lists["query"]]
    walls = {}
    walls["build"], _, _ = run_card_cli(
        clust_greedy.main, g + ["--build", "-l", "-i", lists["build"], "-o",
                                os.path.join(wb, "g.cluster")], wb)
    walls["query --device"], qd_l, _ = run_card_cli(
        clust_greedy.main, g + ["--query", "--device", "-o",
                                os.path.join(wb, "qd.tsv")] + q, wb)
    walls["query"], qh_l, _ = run_card_cli(
        clust_greedy.main, g + ["--query", "-o", os.path.join(wb, "q.tsv")]
        + q, wb)
    # the serial query_topk loop's TSV, written on the host
    gst = KssdClusterState.load_repdb(os.path.join(wb, "g.db"))
    qss, _ = sketch_files_kssd(read_file_list(lists["query"]), 10000,
                               gst.kmer_size, gst.params.drlevel,
                               os.cpu_count() or 1)
    t0 = time.perf_counter()
    write_query_tsv(gst, qss, os.path.join(wb, "q_serial.tsv"), 5)
    walls["query, serial loop"] = time.perf_counter() - t0
    for name in ("qd.tsv", "q.tsv"):
        if not same_file(os.path.join(wb, name),
                         os.path.join(wb, "q_serial.tsv")):
            raise AssertionError(f"18b: {name} differs from the serial "
                                 "query_topk loop's TSV")
    if qd_l["filter_mask"] <= 0 or qh_l["filter_mask"] <= 0:
        raise AssertionError(f"18b: K1 launches {qd_l['filter_mask']} "
                             f"under --device, {qh_l['filter_mask']} "
                             "without")
    walls["assign"], _, _ = run_card_cli(
        clust_greedy.main, g + ["--assign", "-o",
                                os.path.join(wb, "a.tsv")] + q, wb)
    walls["stats"], _, _ = run_card_cli(clust_greedy.main, g + ["--stats"],
                                        wb)
    # the append grows its RepDB in place: a copy, so that (d) queries the
    # RepDB the TSVs above came from
    shutil.copy(os.path.join(wb, "g.db"), os.path.join(wb, "g_app.db"))
    walls["append"], _, _ = run_card_cli(
        clust_greedy.main, g[:2] + [os.path.join(wb, "g_app.db")] + g[3:]
        + ["--append", lists["query"], "-l", "-o",
           os.path.join(wb, "app.cluster")], wb)
    # the MST RepDB built by the CLI, which takes the dense engine with or
    # without --device, and on the host from the native compute_mst
    mst_db = {}
    for how, flag in (("device", ["--device"]), ("no_device", [])):
        mst_db[how] = os.path.join(wb, f"m_{how}.db")
        walls[f"MST build ({how})"], ml, k4 = run_card_cli(
            clust_mst.main, ["--fast", "--db", mst_db[how], "--build", "-l",
                             "-i", lists["build"], "-d", str(THRESHOLD),
                             "-o", os.path.join(wb, f"m_{how}.cluster")]
            + flag, wb)
        if ml["pair_mask_tiles"] <= 0 or ml["pair_common"] <= 0:
            raise AssertionError(f"18b MST build ({how}): launches {ml}")
        if how == "device":
            launches["pair_mask_tiles"] = ml["pair_mask_tiles"]
            launches["pair_common"] = ml["pair_common"]
    mss, mp = sketch_files_kssd(read_file_list(lists["build"]), 10000, 21,
                                3, os.cpu_count() or 1)
    t0 = time.perf_counter()
    forest = cut_forest(compute_mst(mss.hashes, THRESHOLD, mp.kmer_size).mst,
                        THRESHOLD)
    MstState.from_clustering(
        mss, "kssd", forest, clusters_from_forest(forest, len(mss)),
        THRESHOLD, kmer_size=mp.kmer_size, half_k=mp.half_k,
        half_subk=mp.half_subk, drlevel=mp.drlevel).save(
            os.path.join(wb, "m_host.db"))
    walls["MST build (host compute_mst)"] = time.perf_counter() - t0
    built = {how: MstState.load(path) for how, path in mst_db.items()}
    host = MstState.load(os.path.join(wb, "m_host.db"))
    for how, st_ in built.items():
        if st_.clusters != host.clusters or \
                st_.representative_ids != host.representative_ids:
            raise AssertionError(f"18b: the MST RepDB built on the card "
                                 f"({how}) differs from the host-built one")
    hold_groups(os.path.join(wb, "m_device.cluster"), files[0] + files[1],
                "18b MST build")
    say(f"18b RepDB CLIs over 64 + 64 genomes of 4 Mb: --query (K1 "
        f"launches {qd_l['filter_mask']} with --device, "
        f"{qh_l['filter_mask']} without) byte-equal to the serial "
        f"query_topk loop's TSV; --assign, --stats, --append exit 0; the "
        f"MST RepDB built on the card (K4 mask mode "
        f"{launches['pair_mask_tiles']}, K5b {launches['pair_common']}, "
        f"with or without --device) = the one built on the host from "
        f"compute_mst (clusters, representatives; files byte-equal: "
        + str([same_file(p_, os.path.join(wb, "m_host.db"))
               for p_ in mst_db.values()]) + "); walls (s) "
        + ", ".join(f"{k_} {v:.3f}" for k_, v in walls.items()))
    # (c) --save-rep, then --append of copies 2-3
    builds = files[0] + files[1]
    for tag, main, flags, state in (
            ("clust-mst --fast", clust_mst.main, ["--fast"],
             "mst_cluster_state.bin"),
            ("clust-greedy --fast", clust_greedy.main, ["--fast"],
             "cluster_state.bin"),
            ("MinHash clust-mst", clust_mst.main, [], None),
            ("MinHash clust-greedy", clust_greedy.main, [],
             "cluster_state.bin")):
        wc = os.path.join(work, "c", tag.replace(" ", "_"))
        argv = flags + ["--device", "-d", str(THRESHOLD), "-l"]
        w_src, _, _ = run_card_cli(
            main, argv + ["--save-rep", "-i", lists["build"], "-o",
                          os.path.join(wc, "src.cluster")],
            os.path.join(wc, "src"))
        (src,) = [os.path.join(wc, "src", d) for d in
                  os.listdir(os.path.join(wc, "src"))
                  if os.path.isdir(os.path.join(wc, "src", d))]
        if state and not os.path.exists(os.path.join(src, state)):
            raise AssertionError(f"18c {tag}: --save-rep wrote no {state}")
        before = folder_digest(src)
        out = os.path.join(wc, "app.cluster")
        w_app, al, k4 = run_card_cli(
            main, argv + ["--presketched", src, "--append", lists["query"],
                          "-o", out], os.path.join(wc, "app"))
        changed = {k_ for k_ in set(before) | set(folder_digest(src))
                   if before.get(k_) != folder_digest(src).get(k_)}
        # the KSSD MST state is saved again in its folder after the append
        if changed != ({state} if tag == "clust-mst --fast" else set()):
            raise AssertionError(f"18c {tag}: the append changed {changed} "
                                 "in its source folder")
        back = hold_groups(out, builds + files[2] + files[3], f"18c {tag}")
        note = ""
        if state is None:
            # the classic MinHash append: K4's mask mode from start_index
            starts = {(a[1] is not None, a[7]) for a, _ in k4.calls}
            if al["pair_mask_tiles"] <= 0 or starts != {(True, 64)}:
                raise AssertionError(f"18c {tag}: K4 launches "
                                     f"{al['pair_mask_tiles']}, (two "
                                     f"planes, start_index) {starts}")
            ss, p = sketch_io.load_minhash_sketches(src)
            ss.extend(sketch_files_minhash(read_file_list(lists["query"]),
                                           10000, p, os.cpu_count() or 1))
            t0 = time.perf_counter()
            ref = compute_mst(ss.hashes, THRESHOLD, p.kmer_size,
                              start_index=64,
                              pre_edges=sketch_io.load_mst(src))
            host_s = time.perf_counter() - t0
            (new,) = [os.path.join(wc, "app", d) for d in
                      os.listdir(os.path.join(wc, "app"))
                      if os.path.isdir(os.path.join(wc, "app", d))]
            rel = hold_mst(sketch_io.load_mst(new), ref.mst, len(ss), tag)
            launches["pair_mask_tiles_append"] = al["pair_mask_tiles"]
            note = (f"; K4 mask mode launches {al['pair_mask_tiles']} on two "
                    f"planes from start_index 64, the MST = the native "
                    f"compute_mst(start_index=64, pre_edges) (weights "
                    f"within {rel:.3e}; host {host_s:.3f} s)")
        say(f"18c {tag}: --save-rep {w_src:.3f} s, --append of 64 "
            f"{'through ' + state if state else '(classic)'} {w_app:.3f} "
            f"s: the 32 planted groups ({back} representatives put back); "
            f"source folder {'unchanged' if not changed else 'changed in ' + str(sorted(changed))}"
            + note)
    # (d) --db --query/--assign --multihost, two ranks on cuda:0
    for verb, single in (("--query", "q.tsv"), ("--assign", "a.tsv")):
        multi = os.path.join(work, f"multi_{single}")
        t0 = time.perf_counter()
        rc = pl.launch(2, g + [verb, "-o", multi] + q, module="greedy",
                       timeout=600)
        multi_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"18d {verb} --multihost returned {rc}")
        if not same_file(multi, os.path.join(wb, single)):
            raise AssertionError(f"18d {verb} --multihost differs from the "
                                 "single-process TSV")
        say(f"18d --db {verb} --multihost, 2 processes on cuda:0: TSV "
            f"byte-equal to 18b's single-process one; wall {multi_s:.3f} s")
    say("launches (phase 18): " + ", ".join(
        f"{k_}={v}" for k_, v in launches.items()))
    return launches


# the phase directories RTC_PROFILE_DIR writes and the csrc kernels each
# trace must hold (names by substring: templated kernels carry their
# signature)
TRACED_KERNELS = {
    "labelprop_cluster": ("filter_mask_kernel", "lp_round_kernel"),
    "bitmap_filter_cluster": ("filter_mask_kernel",),
    "dense_mst_device_compact": ("pair_tiles_kernel", "pair_common_kernel"),
}


def read_trace(folder):
    """(path, bytes, device events, kernel names) of the one JSON trace in
    ``folder``."""
    files = os.listdir(folder)
    if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
        raise AssertionError(f"{folder}: {files}, not one JSON trace")
    path = os.path.join(folder, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    kernels = sorted({e.get("name", "") for e in device
                      if e.get("cat") == "kernel"})
    return path, os.path.getsize(path), len(device), kernels


def traced_cli_run(main, argv, cwd, prof):
    """One CLI run from ``cwd`` with RTC_PROFILE_DIR at ``prof`` (None:
    unset); (wall, stats, traces written, the profiler's start, stop and
    export seconds)."""
    from rabbittclust_tpu_torch.utils import profiling
    stats = {}
    before = profiling.TRACE_STATS["traces"]
    before_s = profiling.TRACE_STATS["trace_s"]
    with environment({"RTC_PROFILE_DIR": prof}), working_dir(cwd):
        t0 = time.perf_counter()
        rc = main(argv, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{argv[:4]}... returned {rc}")
    return (wall, stats, profiling.TRACE_STATS["traces"] - before,
            profiling.TRACE_STATS["trace_s"] - before_s)


def write_scale_genomes(folder, n_clusters, per_cluster, length, mutation,
                        seed, length_jitter=0):
    """tests/torch_port_data.py::write_scale_genomes: ``n_clusters`` random
    ancestors copied ``per_cluster`` times at ``mutation`` point mutations,
    each cut to ``length - U[0, length_jitter]``, one FASTA file each;
    returns the list file's path."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    os.makedirs(folder, exist_ok=True)
    files = []
    for c in range(n_clusters):
        base = rng.integers(0, 4, length, dtype=np.uint8)
        for m in range(per_cluster):
            g = base.copy()
            hit = rng.random(length) < mutation
            g[hit] = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
            cut = length - int(rng.integers(0, length_jitter + 1))
            files.append(os.path.join(folder, f"g{c}_{m}.fna"))
            with open(files[-1], "wb") as f:
                f.write(f">genome_{c}_{m} cluster{c}\n".encode())
                seq = acgt[g[:cut]].tobytes()
                for k in range(0, cut, 80):
                    f.write(seq[k:k + 80] + b"\n")
    lst = os.path.join(folder, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(files) + "\n")
    return lst


MALLOC_PROBE = r"""
import ctypes, json
calls = []
real = ctypes.CDLL
class Libc:
    def __init__(self, lib):
        self.lib = lib
    def mallopt(self, param, value):
        calls.append([param, value, self.lib.mallopt(param, value)])
def cdll(name, *args, **kwargs):
    lib = real(name, *args, **kwargs)
    return Libc(lib) if name == "libc.so.6" else lib
ctypes.CDLL = cdll
import rabbittclust_tpu_torch
print(json.dumps(calls))
"""


def trace_child(tmp):
    """19a, run by ``chip_smoke.py --trace-child TMP`` in a process of its
    own, as a CLI run is: on the card's machine the card's clock drifts from
    the host's, and a process's profiler sessions lose the card's records
    as out of their window once they start more than about 30 s after its
    first one (PERF.md)."""
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.ops import bitmap as bm
    from rabbittclust_tpu_torch.ops import intersect as ix
    from rabbittclust_tpu_torch.ops import labelprop as lp
    work = os.path.join(tmp, "phase19")
    runs = [("labelprop_cluster", "-e, N=131,072 (phase 6's folder)",
             os.path.join(tmp, "slice_sketches"), {}),
            ("bitmap_filter_cluster", "-e, stream engine forced, N=16,384",
             os.path.join(tmp, "sketches"), {"RTC_CLUSTER_ENGINE": "stream"}),
            ("dense_mst_device_compact", "dense engine, N=2,048",
             os.path.join(tmp, "dense2k_sketches"),
             {"RTC_MST_CLUSTERS_FAST": "0"})]
    for phase, what, folder, env in runs:
        argv = ["--fast", "--device", "--presketched", folder, "-o",
                "out.cluster", "-d", str(THRESHOLD), "-e"]
        prof = os.path.join(work, phase, "prof")
        walls, timers = {}, {}
        with environment(env):
            for arm in ("traced", "plain"):
                cwd = os.path.join(work, phase, arm)
                bm.reset_launches()
                ix.reset_launches()
                lp.reset_launches()
                walls[arm], stats, traces, trace_s = traced_cli_run(
                    main, argv, cwd, prof if arm == "traced" else None)
                timer = (lp.LP_STATS["total_s"]
                         if phase == "labelprop_cluster"
                         else stats.get("clusters_s", stats.get("mst_s")))
                made = sorted(os.listdir(cwd))
                if made != ["out.cluster"]:
                    raise AssertionError(f"19a {phase} {arm}: the working "
                                         f"directory holds {made}")
                if traces != (arm == "traced"):
                    raise AssertionError(f"19a {phase} {arm}: {traces} "
                                         "traces written")
                timers[arm] = timer
                if arm == "traced":
                    launches = {"K1": bm.LAUNCHES["filter_mask"],
                                "K2": lp.LAUNCHES["labelprop_round"],
                                "K4 mask": ix.LAUNCHES["pair_mask_tiles"],
                                "K5b": ix.LAUNCHES["pair_common"]}
                    traced_s = trace_s
                if not same_file(os.path.join(cwd, "out.cluster"),
                                 os.path.join(work, phase, "traced",
                                              "out.cluster")):
                    raise AssertionError(f"19a {phase}: the traced and "
                                         "untraced .cluster files differ")
        if sorted(os.listdir(prof)) != [phase]:
            raise AssertionError(f"19a: {prof} holds "
                                 f"{sorted(os.listdir(prof))}, not {phase}")
        path, size, n_device, kernels = read_trace(os.path.join(prof, phase))
        missing = [k for k in TRACED_KERNELS[phase]
                   if not any(k in name for name in kernels)]
        if missing:
            raise AssertionError(f"19a {phase}: no {missing} in the trace "
                                 f"(kernels: {kernels[:20]})")
        say(f"19a {phase} ({what}): trace {size} B, {n_device} device "
            f"events, kernels {[k[:60] for k in kernels]}; launches "
            f"{launches}; wall traced {walls['traced']:.3f} s, untraced "
            f"{walls['plain']:.3f} s (x"
            f"{walls['traced'] / walls['plain']:.3f}); the profiler's "
            f"start, stop and export {traced_s:.3f} s, kept out of the "
            f"engine's timer ({timers['traced']:.3f} s traced, "
            f"{timers['plain']:.3f} s untraced)")


def phase_traces_and_arms(corpus, tmp, dev):
    """19: (a) RTC_PROFILE_DIR's traces of the three engine phases on the
    card, each against the same run untraced, in a process of its own
    (``trace_child``); (b) the -t 1 MST-free arms at 400 and 5,000 genomes
    on the card against the port's CPU runs; (c) the malloc tuning at
    import."""
    say("== phase 19: RTC_PROFILE_DIR traces, the -t 1 arms, the malloc "
        "tuning at import")
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.ops import bitmap as bm
    save_presketched(corpus[:2048], os.path.join(tmp, "dense2k_sketches"))
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--trace-child", tmp], cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
    for line in child.stdout.splitlines():
        if line.startswith("19a "):
            say(line)
    if child.returncode != 0:
        raise RuntimeError(f"19a failed (rc {child.returncode}): "
                           f"{child.stderr.strip()[-1500:]}")
    say(f"19a's process: {time.perf_counter() - t0:.3f} s")
    work = os.path.join(tmp, "phase19")
    # (b) the -t 1 arms (test_torch_scale.py / test_torch_scale5k.py's
    # parameters, the corpora drawn with numpy)
    t0 = time.perf_counter()
    varied = write_scale_genomes(os.path.join(work, "varied"), 20, 20,
                                 25000, 0.012, 99, length_jitter=5000)
    tie = write_scale_genomes(os.path.join(work, "tie"), 20, 20, 25000,
                              0.012, 99)
    five_k = write_scale_genomes(os.path.join(work, "5k"), 200, 25, 11000,
                                 0.02, 20260820)
    say(f"19b corpora written in {time.perf_counter() - t0:.3f} s")
    arms = [("varied --drlevel 2", varied, ["--drlevel", "2"], "256", 20),
            ("varied --drlevel 2 -k 21", varied,
             ["--drlevel", "2", "-k", "21"], "256", 20),
            ("tie --drlevel 2 -k 21", tie, ["--drlevel", "2", "-k", "21"],
             "256", 20),
            ("5k -k 21 --drlevel 2", five_k, ["--drlevel", "2", "-k", "21"],
             "512", 200)]
    for tag, lst, extra, rb, n_clusters in arms:
        argv = ["--fast", "-l", "-i", lst, "-d", str(THRESHOLD), *extra,
                "-e", "--device", "-t", "1"]
        outs, walls = {}, {}
        with environment({"RTC_CLUSTER_BITS": "2048", "RTC_CLUSTER_RB": rb,
                          "RTC_MST_CLUSTERS_FAST": None}):
            for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
                cwd = os.path.join(work, "arms", tag.replace(" ", "_"), side)
                outs[side] = os.path.join(cwd, "o.cluster")
                bm.reset_launches()
                with working_dir(cwd):
                    t0 = time.perf_counter()
                    rc = main(argv + ["-o", outs[side]], device=d)
                    if d.type == "cuda":
                        torch.cuda.synchronize()
                    walls[side] = time.perf_counter() - t0
                if rc != 0:
                    raise RuntimeError(f"19b {tag} on the {side} returned "
                                       f"{rc}")
                if side == "card":
                    launched = bm.LAUNCHES["filter_mask"]
        if launched <= 0:
            raise AssertionError(f"19b {tag}: K1 was not launched")
        if not same_file(outs["card"], outs["cpu"]):
            raise AssertionError(f"19b {tag}: the card's .cluster differs "
                                 "from the CPU run's")
        got = len(read_cluster_file(outs["card"]))
        if got != n_clusters:
            raise AssertionError(f"19b {tag}: {got} clusters, not "
                                 f"{n_clusters}")
        say(f"19b -e --device -t 1, {tag} (2048 bits, rb {rb}): .cluster "
            f"byte-equal to the CPU run's, {got} clusters; K1 launches "
            f"{launched}; wall card {walls['card']:.3f} s, cpu "
            f"{walls['cpu']:.3f} s")
    # (c) the malloc tuning: the two mallopt calls at import, none under
    # RTC_MALLOC_REUSE=0
    for value, want in ((None, [[-3, 1 << 30, 1], [-1, 1 << 30, 1]]),
                        ("0", [])):
        env = {k: v for k, v in os.environ.items() if k != "RTC_MALLOC_REUSE"}
        if value is not None:
            env["RTC_MALLOC_REUSE"] = value
        probe = subprocess.run([sys.executable, "-c", MALLOC_PROBE],
                               cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=300)
        if probe.returncode != 0:
            raise RuntimeError(f"19c probe failed: {probe.stderr[-800:]}")
        calls = json.loads(probe.stdout.strip().splitlines()[-1])
        if calls != want:
            raise AssertionError(f"19c RTC_MALLOC_REUSE={value}: mallopt "
                                 f"calls {calls}, not {want}")
        say(f"19c import under RTC_MALLOC_REUSE={value or 'unset'}: mallopt "
            f"calls (param, value, result) {calls}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    import rabbittclust_tpu_torch  # noqa: F401  (fails outside the repo)
    if sys.argv[1:2] == ["--trace-child"]:
        trace_child(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--mesh-child"]:
        mesh_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5], sys.argv[6])
        return 0
    dev = torch.device("cuda", 0)
    card = phase_identify()
    phase_build()
    if sys.argv[1:2] == ["--parent"]:
        load_parent(sys.argv[2])
    t0 = time.perf_counter()
    # one rng drawn in order: the first 16,384 genomes of the 131,072 are
    # make_corpus(16384, ...)
    corpus = make_corpus(N_SLICE, SKETCH, N_CLUSTERS, SEED)
    hashes = corpus[:N_GENOMES]
    say(f"corpus of {N_SLICE} genomes made in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sparse = make_corpus(N_GREEDY, SKETCH, N_GREEDY // 2, SEED + 3)
    say(f"sparse corpus of {N_GREEDY} genomes (pairs) made in "
        f"{time.perf_counter() - t0:.3f} s")
    greedy_corpora = [("8a", sparse), ("8b", corpus[:N_GREEDY])]
    # phase 16's Python oracles run meanwhile in two worker processes at the
    # lowest priority, so that they take no core from the host code timed
    # in phases 3-15 (they are done before phase 4)
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(
        2, initializer=os.nice, initargs=(19,))
    try:
        oracles = [pool.apply_async(batched_oracle,
                                    (h, kssd_params().kmer_size))
                   for _, h in greedy_corpora]
        pool.close()
        launches, rec = run_phases(corpus, hashes, sparse, greedy_corpora,
                                   oracles, dev, card)
    finally:
        pool.terminate()
        pool.join()
    loaded = [m for m in sys.modules if m in ("jax", "rabbittclust_tpu")
              or m.startswith(("jax.", "rabbittclust_tpu."))]
    if loaded:
        raise AssertionError(f"jax or the JAX package was imported: {loaded}")
    # each kernel's first timed case, its bound and, for K1, K6 and the
    # bitmap and mask rings, the one PyTorch call that computes its
    # product, for K3 torch.nonzero over the unpacked masks, for K4's
    # counts and mask modes and the exact and stats rings torch.sparse.mm
    # of the CSR incidences on the kernel's own case (the exact ring's
    # interior 4096^2 step, the stats ring's 256-row band of it; a
    # library_note where PyTorch refuses it; no
    # single call computes K2's, K5b's, K7's, K8's or the LP round's
    # function); launches from the run of the path that uses the
    # kernel (K4's counts mode is on no path: the dense engine takes its
    # mask mode; K3's from phase 11's first idx run, K7's from phase 13's
    # first device run, K8's and its id pass's from phase 14's WMH run,
    # K6's from phase 16's 8a run, the rings' from phase 15).  K6's, K8's,
    # the ring steps' and the LP slab round's ms and library_ms are kernel
    # times (device_ms); their call times, and the
    # bitmap ring's close, ride along as extra keys
    extra = ("call_ms", "library_call_ms", "library_note", "close_ms",
             "close_call_ms")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": rec[name]["err"],
                "ms": rec[name]["ms"][0], "plain_ms": rec[name]["plain_ms"][0],
                "bound_ms": rec[name]["bound"][0][0],
                "bound_by": rec[name]["bound"][0][1],
                "library_ms": rec[name].get("library_ms"),
                **{k_: rec[name][k_] for k_ in extra if k_ in rec[name]}}
               for name, (src, replaces) in KERNELS.items()]
    say(f"device times by timer: {DEVICE_TIMER}")
    say(f"script seconds: {time.perf_counter() - T_START:.1f}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(corpus, hashes, sparse, greedy_corpora, oracles, dev, card):
    """Phases 3-19; returns (launches, kernel records)."""
    rec = phase_kernels(hashes, dev)
    b1_ops = phase_filter_kernel(hashes, dev, rec, card)
    phase_round_kernel(corpus, dev, rec, card, b1_ops)
    phase_compact_kernel(hashes, sparse, corpus, dev, rec, card)
    phase_sketch_kernel(dev, rec, card)
    phase_match_kernel(dev, rec, card)
    phase_greedy_filter_kernel(greedy_corpora, dev, rec, card, b1_ops)
    # phase 9's MinHash corpus of 64-bit hashes, also 3h's 64-bit case
    wide = make_corpus(N_GENOMES, SKETCH, N_CLUSTERS, SEED + 5,
                       dtype=np.uint64)
    phase_ring_kernels(corpus, wide, dev, rec, card, b1_ops)
    say("phase 16's oracles " + ", ".join(
        f"{tag}: {'done' if o.ready() else 'running'}"
        for (tag, _), o in zip(greedy_corpora, oracles)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tmp",
                                     dir=ROOT) as tmp:
        launches, want, host_mst, dense_mst = phase_end_to_end(hashes, dev,
                                                               tmp)
        phase_from_fasta(tmp)
        launches.update(phase_slice(corpus, dev, tmp))
        phase_engines(hashes, want, dev)
        phase_greedy(sparse, tmp, "8a", None)
        phase_greedy(corpus[:N_GREEDY], tmp, "8b", "force")
        phase_minhash(wide, tmp)
        phase_append(tmp, N_GENOMES)
        launches["mask_compact"] = phase_dbscan(
            [("sparse", sparse, 2), ("planted", hashes, 5)], tmp)
        phase_leiden(hashes, tmp)
        launches.update(phase_device_sketch(tmp, dev))
        launches.update(phase_extra_sketch(tmp, dev))
        launches.update(phase_mesh(corpus, want, dev, tmp))
        launches["greedy_filter"] = phase_batched_greedy(greedy_corpora,
                                                         oracles, dev)
        launches.update(phase_multiprocess(hashes, want, host_mst,
                                           dense_mst, dev, tmp, card, rec))
        phase_state_repdb(tmp, dev, card)
        phase_traces_and_arms(corpus, tmp, dev)
    return launches, rec


if __name__ == "__main__":
    sys.exit(main())
