"""clust-mst --fast --device workflows on the GPU (counterpart of the MST
branch of ``rabbittclust_tpu/workflows.py``).

Sketching, persistence and the output tail (trees, auto-threshold, cluster
files, noise removal, dedup/reps) are the shared host functions; only the
engines differ, on an explicit torch device: the MST-free cluster engines
of ``ops/cluster_fast.py`` for ``-e`` with no MST consumer, the dense
exact-MST engine of ``ops/engine.py`` otherwise.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .host import (
    KssdParams,
    SketchSet,
    Timer,
    read_file_list,
    shared_wf,
    sketch_files_kssd,
    sketch_io,
    sketch_sequences_kssd,
    write_cluster_file,
)
from .ops.cluster_fast import (
    threshold_clusters_device,
    threshold_clusters_device_exact_order,
)
from .ops.engine import compute_mst_device

log = shared_wf.log
OutputOptions = shared_wf.OutputOptions


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
        clusters, _ = shared_wf._mst_outputs(ss, res, threshold, output_file,
                                             opts, folder)
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


# --premsted needs no pair engine: the shared host function
clust_from_mst_fast = shared_wf.clust_from_mst_fast
