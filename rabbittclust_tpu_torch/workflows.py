"""clust-mst --fast --device workflows on the GPU (counterpart of the MST
branch of ``rabbittclust_tpu/workflows.py``).

Sketching, persistence and the output tail (trees, auto-threshold, cluster
files, noise removal, dedup/reps) are the port's copies of the JAX
package's host code; only the engines differ, on an explicit torch device:
the MST-free cluster engines of ``ops/cluster_fast.py`` for ``-e`` with no
MST consumer, the dense exact-MST engine of ``ops/engine.py`` otherwise.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .cluster.mst import (
    MstResult,
    clusters_from_forest,
    cut_forest,
    get_noise_nodes,
    modify_forest,
)
from .distance.mash import max_distance_for_sketch
from .io.fasta import read_file_list
from .io.prescan import cal_size
from .ops.cluster_fast import (
    threshold_clusters_device,
    threshold_clusters_device_exact_order,
)
from .ops.engine import compute_mst_device
from .sketch.base import SketchSet
from .sketch.kssd import KssdParams, sketch_files_kssd, sketch_sequences_kssd
from .state import sketch_io
from .state.cluster_io import write_cluster_file
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


def _compute_mst_engine(ss: SketchSet, threshold: float, kmer_size: int,
                        is_containment: bool, opts: OutputOptions,
                        device: torch.device,
                        stats: Optional[dict] = None):
    """The single-device branch of the JAX ``_compute_mst_engine``."""
    if device.type == "cuda":
        if torch.cuda.device_count() > 1:
            log(f"-----{torch.cuda.device_count()} GPUs visible: using "
                f"{device} only (multi-GPU is not ported yet)")
        log(f"-----using the dense MST engine on {device} "
            f"({torch.cuda.get_device_name(device)})")
    else:
        log(f"-----using the dense MST engine on {device} (plain torch)")
    return compute_mst_device(
        ss.hashes, threshold, kmer_size, is_containment=is_containment,
        with_dense=opts.dense, device=device, stats=stats)


def _mst_free_clusters(ss: SketchSet, p: KssdParams, threshold: float,
                       output_file: str, is_containment: bool, threads: int,
                       device: torch.device, stats: Optional[dict]):
    """The MST-free branch of the JAX ``compute_kssd_clusters``: ``-t 1``
    gives the reference's serial member order, ``-t >1`` the BFS order of
    the verified spanning forest; the partition is the same."""
    timer = Timer()
    phase = "computing clusters (device, MST-free)"
    if threads == 1:
        log("-----using the MST-free device cluster engine "
            "(-t 1: reference serial member order)")
        with timer.phase(phase):
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
        with timer.phase(phase):
            clusters = threshold_clusters_device(
                ss.hashes, threshold, p.kmer_size,
                is_containment=is_containment, device=device)
    write_cluster_file(output_file, clusters, ss, threshold)
    log(f"-----write the cluster result into: {output_file}")
    log(f"-----the number of clusters is: {len(clusters)}")
    if stats is not None:
        stats["clusters_s"] = timer.phases[phase]
    return clusters, ss


def compute_kssd_clusters(ss: SketchSet, p: KssdParams, threshold: float,
                          output_file: str,
                          is_containment: bool, opts: OutputOptions,
                          folder: Optional[str], device: torch.device,
                          stats: Optional[dict] = None, threads: int = 1):
    """The MST module of the JAX ``compute_kssd_clusters``.  ``-e`` with no
    MST consumer takes the MST-free engines, under the JAX package's
    condition (``RTC_MST_CLUSTERS_FAST=0`` restores the dense engine)."""
    if (os.environ.get("RTC_MST_CLUSTERS_FAST", "1") != "0"
            and opts.use_device and not _mst_consumers(opts)):
        return _mst_free_clusters(ss, p, threshold, output_file,
                                  is_containment, threads, device, stats)
    timer = Timer()
    with timer.phase("computing mst"):
        res = _compute_mst_engine(ss, threshold, p.kmer_size, is_containment,
                                  opts, device, stats)
    with timer.phase("outputs"):
        if not opts.no_save and folder:
            sketch_io.ensure_folder(folder)
            sketch_io.save_genome_info(ss, folder, "mst", kssd=True)
            sketch_io.save_mst(res.mst, folder)
            if opts.dense and res.dense is not None:
                sketch_io.save_dense(folder, res.dense)
                sketch_io.save_ani(folder, res.ani)
        clusters, _ = _mst_outputs(ss, res, threshold, output_file, opts,
                                   folder)
    if stats is not None:
        stats["mst_s"] = timer.phases["computing mst"]
        stats["outputs_s"] = timer.phases["outputs"]
    return clusters, ss


def clust_from_genome_fast(input_file: str, output_file: str,
                           folder_path: Optional[str], sketch_by_file: bool,
                           is_containment: bool, kmer_size: int,
                           threshold: float, drlevel: int, min_len: int,
                           threads: int, opts: OutputOptions,
                           device: torch.device,
                           stats: Optional[dict] = None):
    """clust-mst --fast --device from genomes (native KSSD sketching on the
    host, then the device MST engine)."""
    timer = Timer()
    with timer.phase("computing sketch (with index)"):
        if sketch_by_file:
            ss, p = sketch_files_kssd(read_file_list(input_file), min_len,
                                      kmer_size, drlevel, threads)
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
                                 threads)


def clust_from_sketch_fast(folder_path: str, output_file: str,
                           threshold: float, threads: int,
                           is_containment: bool, opts: OutputOptions,
                           device: torch.device,
                           stats: Optional[dict] = None):
    """--presketched path."""
    ss, p = sketch_io.load_kssd_sketches(folder_path)
    log(f"-----load {len(ss)} kssd sketches from: {folder_path}")
    return compute_kssd_clusters(ss, p, threshold, output_file,
                                 is_containment, opts, folder_path, device,
                                 stats, threads)


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
