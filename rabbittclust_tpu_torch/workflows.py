"""clust-mst and clust-greedy ``--device`` workflows on the GPU
(counterpart of ``rabbittclust_tpu/workflows.py``: KSSD ``--fast`` and
MinHash, fresh genomes, ``--presketched``, ``--premsted``, the
``--save-rep`` state files and the KSSD ``--append`` arms; the MinHash
appends are in ``workflows_minhash_append.py``).

Sketching, persistence and the output tail (trees, auto-threshold, cluster
files, noise removal, dedup/reps) are the port's copies of the JAX
package's host code; only the engines differ, on an explicit torch device:
the MST-free cluster engines of ``ops/cluster_fast.py`` for ``-e`` with no
MST consumer, the dense exact-MST engine of ``ops/engine.py`` otherwise,
and the greedy sweeps of ``ops/greedy_device.py`` beside the native greedy
engines of ``cluster/greedy.py``.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .cluster.greedy import greedy_cluster
from .cluster.mst import (
    MstResult,
    clusters_from_forest,
    cut_forest,
    get_noise_nodes,
    modify_forest,
    native_pair_counts,
)
from .distance.mash import max_distance_for_sketch, min_jaccard_for_threshold
from .io.fasta import read_file_list
from .io.prescan import cal_size
from .ops.cluster_fast import (
    threshold_clusters_device,
    threshold_clusters_device_exact_order,
)
from .ops.engine import compute_mst_device
from .ops.greedy_device import greedy_cluster_device, minhash_greedy_device
from .sketch.base import SketchSet
from .sketch.kssd import KssdParams, sketch_files_kssd, sketch_sequences_kssd
from .sketch.minhash import (
    MinHashParams,
    sketch_files_minhash,
    sketch_sequences_minhash,
)
from .state import sketch_io
from .state.cluster_io import write_cluster_file
from .utils.profiling import TRACE_STATS, job, span
from .utils.timers import Timer


# Source: rabbittclust_tpu/workflows.py::log
def log(msg: str) -> None:
    print(msg, file=sys.stderr)


# Source: rabbittclust_tpu/workflows.py::TunedParams
@dataclass
class TunedParams:
    kmer_size: int
    threshold: float
    is_containment: bool
    contain_compress: int
    sketch_size: int
    max_dist: float


# Source: rabbittclust_tpu/workflows.py::tune_kssd_parameters
def tune_kssd_parameters(sketch_by_file: bool, is_set_kmer: bool,
                         input_file: str, threads: int, min_len: int,
                         is_containment: bool, kmer_size: int,
                         threshold: float, drlevel: int) -> TunedParams:
    """Parameter auto-tuning (reference sub_command.cpp:2317-2467)."""
    max_size, min_size, avg_size = cal_size(sketch_by_file, input_file,
                                            threads, min_len)
    compression = 1 << (4 * drlevel)
    sketch_size = avg_size // compression
    kmer_size = _tune_kmer(is_set_kmer, kmer_size, max_size)
    if not is_containment:
        min_jaccard = 1.0 / sketch_size if sketch_size else 1.0
    else:
        denom = min_size // compression
        min_jaccard = 1.0 / denom if denom else 1.0
    max_dist = max_distance_for_sketch(min_jaccard, kmer_size)
    log(f"-----the max recommand distance threshold is: {max_dist}")
    if threshold > max_dist:
        raise ValueError(
            f"tune_parameters(): the threshold {threshold} is out of the "
            f"valid distance range estimated by Mash distance or AAF distance")
    return TunedParams(kmer_size=kmer_size, threshold=threshold,
                       is_containment=is_containment, contain_compress=0,
                       sketch_size=sketch_size, max_dist=max_dist)


# Source: rabbittclust_tpu/workflows.py::tune_parameters
def tune_parameters(sketch_by_file: bool, is_set_kmer: bool, input_file: str,
                    threads: int, min_len: int, is_containment: bool,
                    is_jaccard: bool, kmer_size: int, threshold: float,
                    contain_compress: int, sketch_size: int,
                    greedy_default_containment: bool = False) -> TunedParams:
    """MinHash parameter auto-tuning (reference sub_command.cpp:2317-2467);
    clust-greedy defaults to containment (``greedy_default_containment``,
    sub_command.cpp:2392-2407)."""
    max_size, min_size, avg_size = cal_size(sketch_by_file, input_file,
                                            threads, min_len)
    if is_containment and is_jaccard:
        raise ValueError("conflicting Mash (fixed-size) and AAF "
                         "(variable-size) distance measurements")
    if greedy_default_containment:
        if not is_containment and not is_jaccard:
            contain_compress = max(avg_size // 1000, 1)
            is_containment = True
        elif is_containment and avg_size // max(contain_compress, 1) < 10:
            log(f"the containCompress {contain_compress} is too large and "
                f"the sketch size is too small")
            contain_compress = max(avg_size // 1000, 1)
            log(f"set the containCompress to: {contain_compress}")
    kmer_size = _tune_kmer(is_set_kmer, kmer_size, max_size)
    if not is_containment:
        min_jaccard = 1.0 / sketch_size
    else:
        denom = min_size // max(contain_compress, 1)
        min_jaccard = 1.0 / denom if denom else 1.0
    max_dist = max_distance_for_sketch(min_jaccard, kmer_size)
    log(f"-----the max recommand distance threshold is: {max_dist}")
    if threshold > max_dist:
        raise ValueError(
            f"tune_parameters(): the threshold {threshold} is out of the "
            f"valid distance range estimated by Mash distance or AAF distance")
    return TunedParams(kmer_size=kmer_size, threshold=threshold,
                       is_containment=is_containment,
                       contain_compress=contain_compress,
                       sketch_size=sketch_size, max_dist=max_dist)


# Source: rabbittclust_tpu/workflows.py::_tune_kmer
def _tune_kmer(is_set_kmer: bool, kmer_size: int, max_size: int) -> int:
    warning_rate = 0.01
    recommend_rate = 0.0001
    recommended = math.ceil(
        math.log(max_size * (1 - recommend_rate) / recommend_rate) / math.log(4))
    warning = math.ceil(
        math.log(max_size * (1 - warning_rate) / warning_rate) / math.log(4))
    if not is_set_kmer:
        return recommended
    if kmer_size < warning:
        log(f"the kmerSize {kmer_size} is too small for the maximum genome "
            f"size of {max_size}")
        log(f"replace the kmerSize to the: {recommended} for reducing the "
            f"random collision of kmers")
        return recommended
    if kmer_size > recommended + 3:
        log(f"the kmerSize {kmer_size} maybe too large for the maximum "
            f"genome size of {max_size}")
        log(f"replace the kmerSize to the {recommended} for increasing the "
            f"sensitivity of genome comparison")
        return recommended
    return kmer_size


# Source: rabbittclust_tpu/workflows.py::OutputOptions
@dataclass
class OutputOptions:
    newick_tree: bool = False
    phylip_tree: bool = False
    nexus_tree: bool = False
    linkage_matrix: bool = False
    auto_threshold: bool = False
    stability: bool = False
    dense: bool = False
    dedup_dist: float = -1.0
    reps_per_cluster: int = 0
    save_rep: bool = False
    no_save: bool = False
    use_device: bool = False     # the device pair engine for the distance phase


# Source: rabbittclust_tpu/workflows.py::_emit_trees
def _emit_trees(ss: SketchSet, mst, output_file: str, opts: OutputOptions):
    if not (opts.newick_tree or opts.phylip_tree or opts.nexus_tree
            or opts.linkage_matrix):
        return
    from .post.trees import (
        write_linkage_matrix,
        write_newick_tree,
        write_nexus_tree,
        write_phylip_tree,
    )
    if opts.newick_tree:
        write_newick_tree(ss, mst, output_file + ".newick.tree")
    if opts.phylip_tree:
        write_phylip_tree(ss, mst, output_file + ".phylip.tree")
    if opts.nexus_tree:
        write_nexus_tree(ss, mst, output_file + ".nexus.tree")
    if opts.linkage_matrix:
        write_linkage_matrix(len(ss), mst, output_file + ".linkage.txt")


# Source: rabbittclust_tpu/workflows.py::_mst_outputs
def _mst_outputs(ss: SketchSet, res: MstResult, threshold: float,
                 output_file: str, opts: OutputOptions,
                 folder_path: Optional[str], kssd: bool = True):
    """Shared tail of every clust-mst workflow: trees, auto-threshold
    report, clusters, per-cluster noise removal, dedup/reps.

    Matches reference semantics: auto-threshold only *reports* (clustering
    keeps the user threshold, sub_command.cpp:1853-1897); the threshold
    header appears only in the KSSD main cluster file
    (printKssdResult calls at sub_command.cpp:2078 vs printResult at :1898).
    """
    if opts.auto_threshold:
        from .post.auto_threshold import select_and_report_threshold
        select_and_report_threshold(res.mst, output_file,
                                    stability=opts.stability,
                                    fallback=threshold, num_vertices=res.n)
    elif opts.stability:
        from .post.auto_threshold import report_threshold_stability
        report_threshold_stability(res.mst, threshold, output_file,
                                   num_vertices=res.n)
    _emit_trees(ss, res.mst, output_file, opts)

    with span("mst.cut"):
        forest = cut_forest(res.mst, threshold)
        clusters = clusters_from_forest(forest, res.n)
    write_cluster_file(output_file, clusters, ss,
                       threshold if kssd else -1.0)
    log(f"-----write the cluster result into: {output_file}")
    log(f"-----the number of clusters is: {len(clusters)}")

    if opts.dense and res.dense is not None:
        # per-cluster noise removal (reference sub_command.cpp:2105-2128):
        # within each multi-member cluster, flag nodes whose density at the
        # threshold bucket is <= min(cluster Q1 - 1, alpha=2)
        dense_index = min(int(threshold / 0.01), res.dense.shape[0] - 1)
        row = res.dense[dense_index]
        noise: List[int] = []
        for cl in clusters:
            if len(cl) == 1:
                continue
            noise.extend(int(x) for x in
                         np.asarray(cl)[get_noise_nodes(row[np.asarray(cl)])])
        log(f"-----the total noiseArr size is: {len(noise)}")
        new_forest = modify_forest(forest, np.asarray(noise, dtype=np.int64))
        new_clusters = clusters_from_forest(new_forest, res.n)
        write_cluster_file(output_file + ".removeNoise", new_clusters, ss)
        log(f"-----write the cluster without noise into: "
            f"{output_file}.removeNoise")
    if opts.dedup_dist >= 0.0 or opts.reps_per_cluster > 0:
        from .post.postprocess import dedup_and_reps
        dedup_and_reps(ss, forest, clusters, opts.dedup_dist,
                       opts.reps_per_cluster, output_file)
    return clusters, threshold


def _mst_consumers(opts: OutputOptions) -> bool:
    """Whether anything but the threshold cut reads the MST (the JAX
    package's condition for leaving its MST-free ``-e`` engine)."""
    return (not opts.no_save or opts.dense or opts.save_rep
            or opts.newick_tree or opts.phylip_tree or opts.nexus_tree
            or opts.linkage_matrix or opts.auto_threshold or opts.stability
            or opts.dedup_dist >= 0.0 or opts.reps_per_cluster > 0)


def mesh_devices(device: torch.device) -> List[torch.device]:
    """The mesh ``--device`` runs on: every visible CUDA device, or the
    one CPU device the caller passed (the plain versions)."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


# Source: rabbittclust_tpu/workflows.py::_compute_mst_engine (the --device
# branches)
def _compute_mst_engine(ss: SketchSet, threshold: float, kmer_size: int,
                        is_containment: bool, opts: OutputOptions,
                        device: torch.device,
                        stats: Optional[dict] = None, start_index: int = 0,
                        pre_edges=None):
    """The mesh ring engine when more than one CUDA device is visible
    (``RTC_MESH``: ``auto``, the default; ``1`` forces it, any other value
    keeps one device), else the dense MST engine on ``device``."""
    devices = mesh_devices(device)
    mesh_pref = os.environ.get("RTC_MESH", "auto")
    use_mesh = (mesh_pref == "1" or
                (mesh_pref == "auto" and len(devices) > 1)) \
        and start_index == 0 and pre_edges is None and not opts.dense
    if use_mesh:
        # ring-sharded pair tiles over the mesh (edge-partition MST
        # theorem).  The bitmap ring suffices when the MST is only cut at
        # <= threshold (plain -e cluster run); anything that persists or
        # analyzes the MST (edge.mst reuse at other thresholds, trees,
        # auto-threshold) needs the full exact ring.
        from .parallel.dist_engine import distributed_mst, make_mesh
        full = (not opts.no_save) or opts.newick_tree \
            or opts.phylip_tree or opts.nexus_tree \
            or opts.linkage_matrix or opts.auto_threshold \
            or opts.stability
        log(f"-----using the {len(devices)}-device mesh ring engine "
            f"({'exact' if full else 'bitmap'})")
        return distributed_mst(ss.hashes, threshold, kmer_size,
                               is_containment=is_containment,
                               mesh=make_mesh(devices=devices),
                               full_mst=full)
    if device.type == "cuda":
        log(f"-----using the dense MST engine on {device} "
            f"({torch.cuda.get_device_name(device)})")
    else:
        log(f"-----using the dense MST engine on {device} (plain torch)")
    return compute_mst_device(
        ss.hashes, threshold, kmer_size, is_containment=is_containment,
        with_dense=opts.dense, start_index=start_index, pre_edges=pre_edges,
        device=device, stats=stats)


def _save_mst_run(ss: SketchSet, res, folder: str, kssd: bool) -> None:
    """The MST run's files: genome info, edge.mst and, with --dense, the
    density and ANI files (the span ``mst.save``)."""
    with span("mst.save"):
        sketch_io.ensure_folder(folder)
        sketch_io.save_genome_info(ss, folder, "mst", kssd=kssd)
        sketch_io.save_mst(res.mst, folder)
        if res.dense is not None:
            sketch_io.save_dense(folder, res.dense)
            sketch_io.save_ani(folder, res.ani)


def _mst_free_clusters(ss: SketchSet, p: KssdParams, threshold: float,
                       output_file: str, is_containment: bool, threads: int,
                       device: torch.device, stats: Optional[dict]):
    """The MST-free branch of the JAX ``compute_kssd_clusters``: ``-t 1``
    gives the reference's serial member order, ``-t >1`` the BFS order of
    the verified spanning forest; the partition is the same."""
    timer = Timer()
    phase = "computing clusters (device, MST-free)"
    traced = TRACE_STATS["trace_s"]
    if threads == 1:
        log("-----using the MST-free device cluster engine "
            "(-t 1: reference serial member order)")
        with timer.phase(phase, "mst_free.clusters"):
            clusters, exact = threshold_clusters_device_exact_order(
                ss.hashes, threshold, p.kmer_size,
                is_containment=is_containment, device=device)
        if not exact:
            log("-----note: clusters share hashes across the threshold "
                "partition — ran the full serial engine for the "
                "reference-exact member order")
    else:
        log("-----using the MST-free device cluster engine "
            "(partition-exact; member order is deterministic but not the "
            "serial reference's — use -t 1 for that)")
        with timer.phase(phase, "mst_free.clusters"):
            clusters = threshold_clusters_device(
                ss.hashes, threshold, p.kmer_size,
                is_containment=is_containment, device=device)
    write_cluster_file(output_file, clusters, ss, threshold)
    log(f"-----write the cluster result into: {output_file}")
    log(f"-----the number of clusters is: {len(clusters)}")
    if stats is not None:  # RTC_PROFILE_DIR's profiler is in no timer
        stats["clusters_s"] = (timer.phases[phase]
                               - (TRACE_STATS["trace_s"] - traced))
    return clusters, ss


# Source: rabbittclust_tpu/workflows.py::_greedy_corpus_is_dense
def _greedy_corpus_is_dense(hashes, threshold: float, kmer_size: int,
                            probe_n: int = 1024,
                            degree_cut: float = 10.0,
                            stats: Optional[dict] = None) -> bool:
    """Candidate-density probe for the --device greedy crossover: exact
    candidate pairs (greedy accept bound) among the ``probe_n`` largest
    genomes via the native pair engine; dense iff the average per-genome
    candidate degree exceeds ``degree_cut``.  Small corpora (< 16384)
    always count as dense — fixed device costs dominate there regardless
    of density.  Both constants come from the JAX package's TPU A/B; the
    two routes give the same clusters, so they move only time.  ``stats``
    receives the probe's degree (``probe_degree``)."""
    n = len(hashes)
    if n < 16384:
        return True
    m = min(probe_n, n)
    sub = hashes[:m]  # size-sorted corpus: the sweep's own first tile
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    pairs = len(native_pair_counts(sub, j_min=j_min * (1.0 - 1e-9),
                                   ratio2=2)[0])
    degree = 2.0 * pairs / m
    if stats is not None:
        stats["probe_degree"] = degree
    return degree >= degree_cut


def _greedy_clusters(ss: SketchSet, p: KssdParams, threshold: float,
                     output_file: str, device: torch.device,
                     stats: Optional[dict]):
    """The greedy module of the JAX ``compute_kssd_clusters``: the KSSD
    greedy order, then the native engine or the device sweep by
    ``RTC_GREEDY_DEVICE`` (``auto``: the density probe; ``native``;
    ``force``); returns the result and the reordered set.  ``stats``
    receives ``greedy_route`` ("native" or "device"), ``greedy_s`` and, on
    the device route, ``sweep_s`` and ``replay_s``."""
    st = {} if stats is None else stats
    order = ss.kssd_greedy_order()
    ss2 = ss.reorder(order)
    mode = os.environ.get("RTC_GREEDY_DEVICE", "auto")
    timer = Timer()
    with timer.phase("greedy"):
        if mode != "native" and not (
                mode == "auto" and _greedy_corpus_is_dense(
                    ss2.hashes, threshold, p.kmer_size, stats=st)):
            st["greedy_route"] = "device"
            gres = greedy_cluster_device(
                ss2.hashes, threshold, p.kmer_size, presorted=True,
                is_containment=False, device=device, stats=st)
        else:
            if mode == "auto":
                log("-----device greedy: dense corpus — routing to the "
                    "native engine (RTC_GREEDY_DEVICE=force overrides)")
            st["greedy_route"] = "native"
            gres = greedy_cluster(ss2.hashes, threshold, p.kmer_size,
                                  presorted=True, is_containment=False)
    st["greedy_s"] = timer.phases["greedy"]
    # greedy main output has no threshold header (sub_command.cpp:1969)
    write_cluster_file(output_file, gres.clusters, ss2)
    log(f"-----write the cluster result into: {output_file}")
    log(f"-----the number of clusters is: {len(gres.clusters)}")
    return gres, ss2


def compute_kssd_clusters(ss: SketchSet, p: KssdParams, threshold: float,
                          output_file: str,
                          is_containment: bool, opts: OutputOptions,
                          folder: Optional[str], device: torch.device,
                          stats: Optional[dict] = None, threads: int = 1,
                          module: str = "mst"):
    """The JAX ``compute_kssd_clusters``: the greedy module, or the MST
    module.  There ``-e`` with no MST consumer takes the MST-free engines,
    under the JAX package's condition (``RTC_MST_CLUSTERS_FAST=0``
    restores the dense engine).  The call is one job scope
    (``utils/profiling.py::job``): given ``stats``, it receives the job's
    ``spans`` and ``counters`` too."""
    with job(stats):
        return _kssd_clusters(ss, p, threshold, output_file, is_containment,
                              opts, folder, device, stats, threads, module)


def _kssd_clusters(ss, p, threshold, output_file, is_containment, opts,
                   folder, device, stats, threads, module):
    if module == "greedy":
        gres, ss2 = _greedy_clusters(ss, p, threshold, output_file, device,
                                     stats)
        # Source: rabbittclust_tpu/workflows.py::compute_kssd_clusters (the
        # greedy --save-rep writer)
        if opts.save_rep and folder:
            from .state.greedy_state import KssdClusterState
            st = KssdClusterState.from_clustering(ss2, p, gres, threshold)
            st.save(os.path.join(folder, "cluster_state.bin"))
        return gres.clusters, ss2
    if (os.environ.get("RTC_MST_CLUSTERS_FAST", "1") != "0"
            and opts.use_device and not _mst_consumers(opts)):
        return _mst_free_clusters(ss, p, threshold, output_file,
                                  is_containment, threads, device, stats)
    timer = Timer()
    traced = TRACE_STATS["trace_s"]
    with timer.phase("computing mst", "mst.compute"):
        res = _compute_mst_engine(ss, threshold, p.kmer_size, is_containment,
                                  opts, device, stats)
    with timer.phase("outputs", "mst.outputs"):
        if not opts.no_save and folder:
            _save_mst_run(ss, res, folder, kssd=True)
        clusters, used = _mst_outputs(ss, res, threshold, output_file, opts,
                                      folder)
        # Source: rabbittclust_tpu/workflows.py::compute_kssd_clusters (the
        # MST --save-rep writer)
        if opts.save_rep and folder:
            from .state.mst_state import KssdMstState
            st = KssdMstState.from_clustering(ss, p, res.mst, clusters, used)
            st.save(os.path.join(folder, "mst_cluster_state.bin"))
    if stats is not None:  # RTC_PROFILE_DIR's profiler is in no timer
        stats["mst_s"] = (timer.phases["computing mst"]
                          - (TRACE_STATS["trace_s"] - traced))
        stats["outputs_s"] = timer.phases["outputs"]
    return clusters, ss


def clust_from_genome_fast(input_file: str, output_file: str,
                           folder_path: Optional[str], sketch_by_file: bool,
                           is_containment: bool, kmer_size: int,
                           threshold: float, drlevel: int, min_len: int,
                           threads: int, opts: OutputOptions,
                           device: torch.device,
                           stats: Optional[dict] = None,
                           module: str = "mst"):
    """clust-mst / clust-greedy --fast --device from genomes (reference
    sub_command.cpp:1934): native KSSD sketching on the host, or by file
    under ``RTC_DEVICE_SKETCH=1`` the device sketcher (K7, bit-identical),
    then the device engine."""
    timer = Timer()
    with timer.phase("computing sketch (with index)"):
        if sketch_by_file:
            files = read_file_list(input_file)
            if opts.use_device and \
                    os.environ.get("RTC_DEVICE_SKETCH", "0") == "1":
                from .ops.sketch_device import sketch_files_kssd_device
                ss, p = sketch_files_kssd_device(files, min_len, kmer_size,
                                                 drlevel, device=device)
            else:
                ss, p = sketch_files_kssd(files, min_len, kmer_size,
                                          drlevel, threads)
        else:
            ss, p = sketch_sequences_kssd(input_file, min_len, kmer_size,
                                          drlevel, threads)
    log(f"-----the size of sketches (genomes) is: {len(ss)}")
    folder = folder_path or sketch_io.default_folder_path()
    if not opts.no_save:
        sketch_io.ensure_folder(folder)
        sketch_io.save_kssd_sketches(ss, p, folder)
        sketch_io.save_kssd_index(ss.hashes, ss.use64, folder)
    if stats is not None:
        stats["sketch_s"] = timer.phases["computing sketch (with index)"]
    return compute_kssd_clusters(ss, p, threshold, output_file,
                                 is_containment, opts, folder, device, stats,
                                 threads, module)


def clust_from_sketch_fast(folder_path: str, output_file: str,
                           threshold: float, threads: int,
                           is_containment: bool, opts: OutputOptions,
                           device: torch.device,
                           stats: Optional[dict] = None,
                           module: str = "mst"):
    """--presketched path."""
    ss, p = sketch_io.load_kssd_sketches(folder_path)
    log(f"-----load {len(ss)} kssd sketches from: {folder_path}")
    return compute_kssd_clusters(ss, p, threshold, output_file,
                                 is_containment, opts, folder_path, device,
                                 stats, threads, module)


# Source: rabbittclust_tpu/workflows.py::clust_from_mst_fast
def clust_from_mst_fast(folder_path: str, output_file: str, threshold: float,
                        threads: int, opts: OutputOptions, kssd: bool = True):
    """--premsted path: re-cluster from a saved MST at a new threshold (no
    pair engine runs).

    ``kssd=False`` replicates the reference's MinHash-premsted quirk of
    omitting the threshold header (sub_command.cpp:1898 vs 1790)."""
    by_file, info = sketch_io.load_genome_info(folder_path, "mst", kssd=kssd)
    mst = sketch_io.load_mst(folder_path)
    n = len(info["names"])
    ss = SketchSet("kssd" if kssd else "minhash", None, by_file,
                   info["use64"])
    for i in range(n):
        ss.append_genome(
            file_name=info["file_names"][i], name=info["names"][i],
            comment=info["comments"][i], seq0_len=info["seq0_lens"][i],
            total_len=info["total_lens"][i], num_seqs=1,
            hashes=np.empty(0, dtype=np.uint64))
    res = MstResult(mst=mst, n=n)
    if opts.dense:
        try:
            res.dense = sketch_io.load_dense(folder_path)
            res.ani = sketch_io.load_ani(folder_path)
        except FileNotFoundError:
            log("-----no dense/ani files in folder; skipping noise removal")
            opts.dense = False
    return _mst_outputs(ss, res, threshold, output_file, opts, folder_path,
                        kssd=kssd)


# Source: rabbittclust_tpu/workflows.py::append_clust_mst_fast (the
# mst_cluster_state.bin branch)
def _append_mst_state(state_file: str, input_file: str, output_file: str,
                      sketch_by_file: bool, min_len: int, threads: int,
                      opts: OutputOptions):
    """``append_clust_mst_fast`` over a folder with a saved
    ``mst_cluster_state.bin`` (KSSD or MinHash, by the state's kind), on
    the host as in the JAX package: the new genomes are sketched with the
    state's parameters and go through the state machine
    (``MstState.append_cluster``)."""
    from .state.mst_state import MstState
    st = MstState.load(state_file)
    if st.kind == "kssd":
        p = KssdParams(half_k=st.half_k, half_subk=st.half_subk,
                       drlevel=st.drlevel)
        if sketch_by_file:
            new_ss, _ = sketch_files_kssd(
                read_file_list(input_file), min_len, p.kmer_size,
                p.drlevel, threads)
        else:
            new_ss, _ = sketch_sequences_kssd(
                input_file, min_len, p.kmer_size, p.drlevel, threads)
    else:
        mp = MinHashParams(kmer_size=st.kmer_size,
                           sketch_size=st.sketch_size,
                           is_containment=st.is_containment,
                           contain_compress=st.contain_compress)
        if sketch_by_file:
            new_ss = sketch_files_minhash(read_file_list(input_file),
                                          min_len, mp, threads)
        else:
            new_ss = sketch_sequences_minhash(input_file, min_len, mp,
                                              threads)
    live = st.append_cluster(new_ss)
    if not opts.no_save:
        st.save(state_file)
    st.write_cluster_result(live, output_file, st.threshold)
    log(f"-----write the cluster result into: {output_file}")
    return live, None


def append_on_host(folder_path: str, module: str, is_fast: bool) -> bool:
    """Whether ``--append`` onto ``folder_path`` is host code alone: an
    append through a saved state (``mst_cluster_state.bin`` for clust-mst,
    ``cluster_state.bin`` for clust-greedy), and the KSSD greedy append,
    which builds its state from the folder when none is saved.  The other
    appends re-cluster on the device engines."""
    if module == "greedy" and is_fast:
        return True
    name = "mst_cluster_state.bin" if module == "mst" else "cluster_state.bin"
    return os.path.exists(os.path.join(folder_path, name))


# Source: rabbittclust_tpu/workflows.py::append_clust_mst_fast
def append_clust_mst_fast(folder_path: str, input_file: str,
                          output_file: str, sketch_by_file: bool,
                          is_containment: bool, min_len: int,
                          threshold: float, threads: int,
                          opts: OutputOptions, device: torch.device,
                          stats: Optional[dict] = None):
    """--append with --presketched/--premsted (reference
    sub_command.cpp:1286-1528): the saved MST medoid state when the folder
    holds ``mst_cluster_state.bin`` (``_append_mst_state``), else the
    classic mode: the new genomes are sketched with the stored parameters,
    and the dense engine runs only the tiles that hold a new genome
    (``start_index``), merged with the saved MST."""
    state_file = os.path.join(folder_path, "mst_cluster_state.bin")
    if os.path.exists(state_file):
        return _append_mst_state(state_file, input_file, output_file,
                                 sketch_by_file, min_len, threads, opts)
    ss, p = sketch_io.load_kssd_sketches(folder_path)
    pre_n = len(ss)
    log(f"-----load {pre_n} pre-generated sketches from: {folder_path}")
    if sketch_by_file:
        files = read_file_list(input_file)
        new_ss, p2 = sketch_files_kssd(files, min_len, p.kmer_size,
                                       p.drlevel, threads)
    else:
        new_ss, p2 = sketch_sequences_kssd(input_file, min_len, p.kmer_size,
                                           p.drlevel, threads)
    if p2 != p:
        raise ValueError(f"append parameter mismatch: {p2} vs stored {p}")
    if new_ss.use64 != ss.use64:
        raise ValueError("append use64 mismatch with stored sketches")
    ss.extend(new_ss)
    pre_mst = None
    try:
        pre_mst = sketch_io.load_mst(folder_path)
    except FileNotFoundError:
        pre_n = 0  # no MST: recompute everything
    res = _compute_mst_engine(ss, threshold, p.kmer_size, is_containment,
                              opts, device, stats,
                              start_index=pre_n if pre_mst else 0,
                              pre_edges=pre_mst)
    # the merged artifacts go into a NEW run folder — the source folder is
    # never mutated (reference append_clust_mst_fast writes
    # new_folder_path, sub_command.cpp:1450-1470)
    out_folder = folder_path
    if not opts.no_save:
        out_folder = sketch_io.default_folder_path()
        sketch_io.ensure_folder(out_folder)
        sketch_io.save_kssd_sketches(ss, p, out_folder)
        sketch_io.save_kssd_index(ss.hashes, ss.use64, out_folder)
        sketch_io.save_genome_info(ss, out_folder, "mst", kssd=True)
        sketch_io.save_mst(res.mst, out_folder)
    return _mst_outputs(ss, res, threshold, output_file, opts, out_folder)


# Source: rabbittclust_tpu/workflows.py::append_clust_greedy_fast
def append_clust_greedy_fast(folder_path: str, input_file: str,
                             output_file: str, sketch_by_file: bool,
                             min_len: int, threshold: float, threads: int,
                             opts: OutputOptions):
    """Greedy append: incremental clustering against the saved state, or,
    without one, against a state built from the pre-sketched genomes (the
    native greedy engine, as the JAX package); host code."""
    from .state.greedy_state import KssdClusterState
    state_file = os.path.join(folder_path, "cluster_state.bin")

    def sketch_new(p):
        if sketch_by_file:
            files = read_file_list(input_file)
            return sketch_files_kssd(files, min_len, p.kmer_size, p.drlevel,
                                     threads)[0]
        return sketch_sequences_kssd(input_file, min_len, p.kmer_size,
                                     p.drlevel, threads)[0]

    if os.path.exists(state_file):
        st = KssdClusterState.load(state_file)
        new_ss = sketch_new(st.params)
        if not opts.no_save:  # new-genome sketches get their own run folder
            nf = sketch_io.default_folder_path()
            sketch_io.ensure_folder(nf)
            sketch_io.save_kssd_sketches(new_ss, st.params, nf)
        st.incremental_cluster(new_ss)
        st.write_cluster_result(output_file)
        # state re-saved only when --save-rep is given on the append run
        # (reference: if (!no_save && save_rep_index), sub_command.cpp)
        if not opts.no_save and opts.save_rep:
            st.save(state_file)
        return st.clusters, None
    # no saved state: build it from the pre-sketched genomes, then append
    # incrementally — the reference's greedy --fast append ALWAYS uses the
    # state machine (KssdInitialClusterWithState + KssdIncrementalCluster),
    # never a full merged re-cluster
    ss, p = sketch_io.load_kssd_sketches(folder_path)
    new_ss = sketch_new(p)
    if not opts.no_save:
        nf = sketch_io.default_folder_path()
        sketch_io.ensure_folder(nf)
        sketch_io.save_kssd_sketches(new_ss, p, nf)
    order = ss.kssd_greedy_order()
    ss2 = ss.reorder(order)
    gres = greedy_cluster(ss2.hashes, threshold, p.kmer_size, presorted=True)
    st = KssdClusterState.from_clustering(ss2, p, gres, threshold)
    if not opts.no_save and opts.save_rep:
        st.save(state_file)
    st.incremental_cluster(new_ss)
    if not opts.no_save and opts.save_rep:
        st.save(state_file)
    st.write_cluster_result(output_file)
    return st.clusters, None


# Source: rabbittclust_tpu/workflows.py::clust_from_genomes
def clust_from_genomes(input_file: str, output_file: str,
                       folder_path: Optional[str], sketch_by_file: bool,
                       kmer_size: int, sketch_size: int, threshold: float,
                       is_containment: bool, contain_compress: int,
                       min_len: int, threads: int, opts: OutputOptions,
                       device: torch.device, stats: Optional[dict] = None,
                       module: str = "mst"):
    """The MinHash arm (no --fast) from genomes."""
    p = MinHashParams(kmer_size=kmer_size, sketch_size=sketch_size,
                      is_containment=is_containment,
                      contain_compress=contain_compress)
    if sketch_by_file:
        files = read_file_list(input_file)
        ss = sketch_files_minhash(files, min_len, p, threads)
    else:
        ss = sketch_sequences_minhash(input_file, min_len, p, threads)
    log(f"-----the size of sketches (genomes) is: {len(ss)}")
    folder = folder_path or sketch_io.default_folder_path()
    if not opts.no_save:
        sketch_io.ensure_folder(folder)
        sketch_io.save_minhash_sketches(ss, folder, kmer_size,
                                        is_containment, contain_compress,
                                        sketch_size)
        sketch_io.save_minhash_index(ss.hashes, folder)
    return compute_minhash_clusters(ss, p, threshold, threads, output_file,
                                    opts, folder, module, device, stats)


# Source: rabbittclust_tpu/workflows.py::compute_minhash_clusters
def compute_minhash_clusters(ss: SketchSet, p: MinHashParams,
                             threshold: float, threads: int,
                             output_file: str, opts: OutputOptions,
                             folder: Optional[str], module: str,
                             device: torch.device,
                             stats: Optional[dict] = None,
                             presketched: bool = False):
    """The MinHash greedy module (``minhash_greedy_device``, K1 under its
    ``minhash`` bound) or MST module (the dense engine).  ``stats``
    receives ``greedy_s``, ``sweep_s`` and ``replay_s`` (greedy) or the
    dense engine's phases (MST)."""
    if module == "greedy":
        # Reference ordering quirk: the FRESH-genome path runs greedy in
        # input order (compute_clusters never sorts,
        # sub_command.cpp:2891-2914); only the PRESKETCHED path sorts, by
        # genome length desc (sub_command.cpp:2658-2660).
        if presketched:
            order = ss.minhash_presketched_order()
        else:
            order = np.arange(len(ss), dtype=np.int64)
        ss2 = ss.reorder(order)
        timer = Timer()
        with timer.phase("greedy"):
            # device sweep with the reference's MinHash-parity semantics
            # (param-size asymmetry, first-touch ties) — bit-exact vs the
            # native engine cluster.greedy.minhash_greedy_parity
            gres = minhash_greedy_device(ss2.hashes, ss2.param_sizes,
                                         threshold, p.kmer_size,
                                         p.is_containment, device=device,
                                         stats=stats)
        if stats is not None:
            stats["greedy_s"] = timer.phases["greedy"]
        write_cluster_file(output_file, gres.clusters, ss2)
        log(f"-----the number of clusters is: {len(gres.clusters)}")
        if opts.save_rep and folder and not opts.no_save:
            from .state.greedy_state import MinHashClusterState
            st = MinHashClusterState.from_clustering(ss2, p, gres, threshold)
            sketch_io.ensure_folder(folder)
            st.save(os.path.join(folder, "cluster_state.bin"))
        return gres.clusters, ss2
    res = _compute_mst_engine(ss, threshold, p.kmer_size, p.is_containment,
                              opts, device, stats)
    if not opts.no_save and folder:
        _save_mst_run(ss, res, folder, kssd=False)
    # MinHash fresh/presketched MST output includes the threshold header
    # (reference printResult calls at sub_command.cpp:2809,3051)
    return _mst_outputs(ss, res, threshold, output_file, opts, folder,
                        kssd=True)


# Source: rabbittclust_tpu/workflows.py::clust_from_sketches
def clust_from_sketches(folder_path: str, output_file: str, threshold: float,
                        threads: int, opts: OutputOptions,
                        device: torch.device, stats: Optional[dict] = None,
                        module: str = "mst"):
    """The MinHash arm's --presketched path."""
    ss, p = sketch_io.load_minhash_sketches(folder_path)
    log(f"-----load {len(ss)} minhash sketches from: {folder_path}")
    return compute_minhash_clusters(ss, p, threshold, threads, output_file,
                                    opts, folder_path, module, device, stats,
                                    presketched=True)
