"""Multi-process workflows: end-to-end clustering from genomes across
``torch.distributed`` processes, with process-sharded ingest (counterpart
of ``rabbittclust_tpu/workflows_dist.py``).

Each process reads and sketches only its contiguous block of the input
file list (reference SketchInfo.cpp:878-980 is the loop being sharded);
the sketch store and the genome metadata are allgathered (sketches are
~genome_len/4096 by design); the bitmap ring runs over the global mesh
(``parallel/multihost.py``).  Every process finishes with the identical
partition; process 0 writes the outputs.

ID parity: sketch ids are input-list order among kept genomes, so the
per-process blocks concatenate to the single-process ordering and the
``.cluster`` file is byte-identical to a single-process run at ``-t 2``
(the deterministic (distance, id) tie order the merged Kruskal keeps).

Launch (one command per card):

    python -m rabbittclust_tpu_torch.cli.clust_mst --fast -l -i list \\
        -o out --multihost host0:8476,NUM_PROCESSES,PROCESS_ID

``python -m rabbittclust_tpu_torch.parallel.launch`` starts N such
processes on one machine; ``RTC_VIRTUAL_CPU_DEVICES=M`` runs each on M
CPU shards.  ``repdb_query_multihost`` serves ``--db --query/--assign
--multihost`` the same way: each process probes its block of the queries.
"""

from __future__ import annotations

import pickle
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .cluster.mst import clusters_from_forest, cut_forest
from .io.fasta import read_file_list
from .sketch.base import SketchSet
from .sketch.kssd import sketch_files_kssd, sketch_sequences_kssd
from .state.cluster_io import write_cluster_file
from .workflows import log, tune_kssd_parameters


# Source: rabbittclust_tpu/workflows_dist.py::_allgather_metadata
def _allgather_metadata(ss: SketchSet) -> List[tuple]:
    """Allgather per-genome metadata records in process (= global id)
    order: (file_name, name, comment, seq0_len, total_len, num_seqs)."""
    from .parallel.multihost import _allgather_ragged

    recs = [(ss.file_names[i], ss.names[i], ss.comments[i], ss.seq0_lens[i],
             ss.total_lens[i], ss.num_seqs[i]) for i in range(len(ss))]
    blob = np.frombuffer(pickle.dumps(recs), dtype=np.uint8)
    out: List[tuple] = []
    for part in _allgather_ragged(blob):
        out.extend(pickle.loads(part.tobytes()))
    return out


# Source: rabbittclust_tpu/workflows_dist.py::parse_multihost_spec
def parse_multihost_spec(spec: str) -> Tuple[str, int, int]:
    """"coordinator:port,num_processes,process_id" -> parsed triple."""
    parts = spec.rsplit(",", 2)
    if len(parts) != 3:
        raise ValueError(
            f"--multihost expects 'coordinator:port,num_processes,"
            f"process_id', got {spec!r}")
    return parts[0], int(parts[1]), int(parts[2])


# Source: rabbittclust_tpu/workflows_dist.py::gather_global_sketches
def gather_global_sketches(local_ss: SketchSet, params,
                           sketch_by_file: bool) -> SketchSet:
    """Allgather every process's sketches + metadata into the full
    SketchSet (identical on every process, global-id order)."""
    from .parallel.multihost import allgather_sketches

    all_hashes = allgather_sketches(local_ss.hashes, local_ss.use64)
    meta = _allgather_metadata(local_ss)
    assert len(meta) == len(all_hashes)
    ss = SketchSet("kssd", params, sketch_by_file, local_ss.use64)
    for (fn, nm, cm, s0, tl, nsq), h in zip(meta, all_hashes):
        ss.append_genome(file_name=fn, name=nm, comment=cm, seq0_len=s0,
                         total_len=tl, num_seqs=nsq, hashes=h)
    return ss


# Source: rabbittclust_tpu/workflows_dist.py::ingest_sharded_kssd
def ingest_sharded_kssd(input_file: str, sketch_by_file: bool,
                        num_processes: int, process_id: int, min_len: int,
                        kmer_size: int, drlevel: int, threads: int):
    """Process-sharded ingest: this process sketches only its contiguous
    block of the input; returns (global SketchSet, params)."""
    from .parallel.multihost import shard_bounds

    if sketch_by_file:
        files = read_file_list(input_file)
        lo, hi = shard_bounds(len(files), num_processes, process_id)
        log(f"-----process {process_id}: sketching files [{lo}, {hi}) of "
            f"{len(files)}")
        local_ss, p = sketch_files_kssd(files[lo:hi], min_len, kmer_size,
                                        drlevel, threads)
    else:
        # by-sequence mode: a single FASTA cannot be read range-sharded
        # without a byte index, so every process sketches the file and
        # keeps only its block of kept sequences; the pair phase is still
        # distributed
        full, p = sketch_sequences_kssd(input_file, min_len, kmer_size,
                                        drlevel, threads)
        lo, hi = shard_bounds(len(full), num_processes, process_id)
        local_ss = full.reorder(np.arange(lo, hi))
    return gather_global_sketches(local_ss, p, sketch_by_file), p


# Source: rabbittclust_tpu/workflows_dist.py::clust_mst_multihost
def clust_mst_multihost(input_file: str, output_file: str,
                        coordinator: str, num_processes: int,
                        process_id: int, *, sketch_by_file: bool = True,
                        is_containment: bool = False,
                        kmer_size: Optional[int] = None,
                        threshold: float = 0.05, drlevel: int = 3,
                        min_len: int = 10000, threads: int = 0,
                        devices: Optional[Sequence] = None,
                        bits: int = 8192, module: str = "mst",
                        resolution: float = 1.0, use_leiden: bool = True,
                        knn_k: int = 0, min_pts: int = 5,
                        max_posting: int = 0):
    """clust-{mst,greedy,leiden,dbscan} --multihost: distributed KSSD
    clustering from genomes.  ``devices``: this process's shards (by
    default ``parallel.multihost.local_devices``: its card, or
    ``RTC_VIRTUAL_CPU_DEVICES`` CPU shards).

    Every process returns the identical (clusters, SketchSet); process 0
    writes the output file."""
    from .parallel import multihost as mh

    mesh = mh.init_multihost(coordinator, num_processes, process_id,
                             devices)
    try:
        # parameter tuning scans file sizes only — identical on every
        # process
        tuned = tune_kssd_parameters(sketch_by_file, kmer_size is not None,
                                     input_file, threads, min_len,
                                     is_containment, kmer_size or 19,
                                     threshold, drlevel)
        t0 = time.perf_counter()
        ss, p = ingest_sharded_kssd(input_file, sketch_by_file,
                                    num_processes, process_id, min_len,
                                    tuned.kmer_size, drlevel, threads)
        ingest_s = time.perf_counter() - t0
        log(f"-----process {process_id}: ingest+sketch+allgather "
            f"{ingest_s:.2f} s")
        n_total = len(ss)
        log(f"-----the size of sketches (genomes) is: {n_total}")
        lo, hi = mh.shard_bounds(n_total, num_processes, process_id)
        t0 = time.perf_counter()
        if module == "greedy":
            clusters, order = mh.multihost_greedy(
                ss.hashes[lo:hi], n_total, threshold, p.kmer_size,
                is_containment=is_containment, mesh=mesh)
            # greedy ids are in the sorted (size-desc) space, like the
            # single-process workflow (compute_kssd_clusters reorders)
            ss = ss.reorder(order)
            header_threshold = None  # greedy main output has no header
        elif module == "dbscan":
            # threshold plays the role of eps (clust-dbscan --eps)
            dbscan_res = mh.multihost_dbscan(
                ss.hashes[lo:hi], n_total, threshold, min_pts, p.kmer_size,
                knn_k=knn_k, max_posting=max_posting, bits=bits, mesh=mesh)
            clusters = dbscan_res.clusters
            header_threshold = None
        elif module == "leiden":
            clusters = mh.multihost_leiden(
                ss.hashes[lo:hi], n_total, threshold, p.kmer_size,
                bits=bits, resolution=resolution, use_leiden=use_leiden,
                knn_k=knn_k, mesh=mesh)
            header_threshold = threshold  # clust-leiden writes the header
        else:
            res = mh.multihost_mst(ss.hashes[lo:hi], n_total, threshold,
                                   p.kmer_size,
                                   is_containment=is_containment, bits=bits,
                                   mesh=mesh)
            forest = cut_forest(res.mst, threshold)
            clusters = clusters_from_forest(forest, n_total)
            header_threshold = threshold
        cluster_s = time.perf_counter() - t0
        log(f"-----process {process_id}: distributed {module} cluster "
            f"phase {cluster_s:.2f} s")
        if process_id == 0:
            if module == "dbscan":
                from .cluster.dbscan import write_dbscan_result
                write_dbscan_result(dbscan_res, ss, output_file, threshold,
                                    min_pts)
            elif header_threshold is not None:
                write_cluster_file(output_file, clusters, ss,
                                   header_threshold)
            else:
                write_cluster_file(output_file, clusters, ss)
            log(f"-----write the cluster result into: {output_file}")
            log(f"-----the number of clusters is: {len(clusters)}")
        return clusters, ss
    finally:
        mh.shutdown_multihost()


# Source: rabbittclust_tpu/workflows_dist.py::repdb_query_multihost
def repdb_query_multihost(db_path: str, input_file: str, output_file: str,
                          coordinator: str, num_processes: int,
                          process_id: int, *, sketch_by_file: bool = True,
                          topk: int = 5, assign: bool = False,
                          min_len: int = 10000, threads: int = 0,
                          devices: Optional[Sequence] = None):
    """Distributed RepDB serving (--db --query/--assign --multihost):
    every process loads the same RepDB replica, sketches ONLY its block of
    the query list, probes it on the host (``query_topk``, as the JAX
    package's processes do), and the gathered hits are written by process 0
    — TSV byte-identical to the single-host query/assign verbs (reference
    sub_command.cpp:337-450 writers).  ``devices``: this process's shards,
    as ``clust_mst_multihost`` takes them (they choose the transport)."""
    import torch.distributed as dist

    from .cli.repdb import write_assign_tsv, write_query_tsv
    from .parallel import multihost as mh
    from .state.greedy_state import KssdClusterState

    mh.init_multihost(coordinator, num_processes, process_id, devices)
    try:
        state = KssdClusterState.load_repdb(db_path)
        if sketch_by_file:
            files = read_file_list(input_file)
            lo, hi = mh.shard_bounds(len(files), num_processes, process_id)
            log(f"-----process {process_id}: sketching query files "
                f"[{lo}, {hi}) of {len(files)}")
            local_ss, _ = sketch_files_kssd(files[lo:hi], min_len,
                                            state.kmer_size,
                                            state.params.drlevel, threads)
            ss = gather_global_sketches(local_ss, state.params, True)
        else:
            ss, _ = sketch_sequences_kssd(input_file, min_len,
                                          state.kmer_size,
                                          state.params.drlevel, threads)
            lo, hi = mh.shard_bounds(len(ss), num_processes, process_id)
            local_ss = ss.reorder(np.arange(lo, hi))
        if assign:
            res = mh.multihost_repdb_assign(state, local_ss.hashes)
        else:
            res = mh.multihost_repdb_query(state, local_ss.hashes, topk)
        if dist.get_rank() == 0:
            if assign:
                write_assign_tsv(state, ss, output_file, precomputed=res)
            else:
                write_query_tsv(state, ss, output_file, topk,
                                precomputed=res)
            log(f"-----write the query result into: {output_file}")
        return res, ss
    finally:
        mh.shutdown_multihost()


# Source: rabbittclust_tpu/workflows_dist.py::main
def main(argv=None) -> int:
    """Module entry (``python -m rabbittclust_tpu_torch.workflows_dist``)
    for launching one multi-process rank directly; ``parallel/launch.py``
    starts the clust_{module} CLIs instead — both accept the same
    options."""
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--multihost", required=True)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-l", "--list", dest="sketch_by_file",
                    action="store_true")
    ap.add_argument("-k", "--kmer-size", dest="kmer_size", type=int,
                    default=None)
    ap.add_argument("-d", "--threshold", type=float, default=0.05)
    ap.add_argument("--drlevel", type=int, default=3)
    ap.add_argument("-m", "--min-length", dest="min_len", type=int,
                    default=10000)
    ap.add_argument("-t", "--threads", type=int, default=0)
    ap.add_argument("--bits", type=int, default=8192)
    ap.add_argument("--module", default="mst",
                    choices=["mst", "greedy", "leiden", "dbscan"])
    ap.add_argument("--minpts", type=int, default=5)
    ap.add_argument("--resolution", type=float, default=1.0)
    ap.add_argument("--louvain", dest="use_louvain", action="store_true")
    ap.add_argument("--knn", dest="knn_k", type=int, default=0)
    ap.add_argument("--max-posting", dest="max_posting", type=int, default=0)
    ap.add_argument("--virtual-cpu-devices", type=int, default=None,
                    help="M CPU shards in this process (as "
                         "RTC_VIRTUAL_CPU_DEVICES=M)")
    args = ap.parse_args(argv)
    coord, n_proc, pid = parse_multihost_spec(args.multihost)
    devices = None
    if args.virtual_cpu_devices:
        devices = [torch.device("cpu")] * args.virtual_cpu_devices
    clust_mst_multihost(
        args.input, args.output, coord, n_proc, pid,
        sketch_by_file=args.sketch_by_file, kmer_size=args.kmer_size,
        threshold=args.threshold, drlevel=args.drlevel,
        min_len=args.min_len, threads=args.threads, bits=args.bits,
        module=args.module, min_pts=args.minpts, knn_k=args.knn_k,
        max_posting=args.max_posting, resolution=args.resolution,
        use_leiden=not args.use_louvain, devices=devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
