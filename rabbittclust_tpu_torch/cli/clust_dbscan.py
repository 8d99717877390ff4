"""clust-dbscan entry point of the port: the ``--device`` arms on an explicit
torch device (reference src/main.cpp:478-522 dispatch).

    python -m rabbittclust_tpu_torch.cli.clust_dbscan --fast --device \\
        -l -i genomes.list -o out.cluster --eps 0.05 --minpts 5

KSSD (``--fast``), from genomes or ``--presketched``: the neighbour pairs
come from the device filter (``ops/bitmap.py::candidate_pairs_threshold``:
K1, and K3 under ``RTC_PULL_MODE=idx``).  As in the JAX package, two arms
run on the host even under ``--device``: ``--max-posting`` > 0 (native
pair counts over the trimmed postings) and ``--minhash`` (the MinHash
engine).  ``--multihost`` runs one rank of the multi-process DBSCAN
(``workflows_dist.py``; KSSD only, as in the JAX CLI).
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import torch

from ..device import resolve_device
from .. import workflows as wf
from ..cluster.dbscan import dbscan_cluster, write_dbscan_result
from .clust_mst import run_multihost
from .common import base_parser, validate_common


# Source: rabbittclust_tpu/cli/clust_dbscan.py::main
def main(argv=None, device: Optional[torch.device] = None,
         stats: Optional[dict] = None) -> int:
    """``device=None`` requires CUDA; ``torch.device("cpu")`` runs the plain
    torch versions of the kernels.  ``stats``, when given, receives the
    seconds of the clustering (``dbscan_s``)."""
    args = base_parser("dbscan").parse_args(argv)
    validate_common(args, "dbscan")
    if args.multihost:
        if args.minhash_dbscan:
            # the library path exists (multihost_dbscan(minhash=True)); the
            # CLI keeps MinHash sketching single-process, as the JAX CLI
            print("ERROR: --multihost clust-dbscan requires --fast "
                  "(KSSD); use parallel.multihost.multihost_dbscan("
                  "minhash=True) from the API", file=sys.stderr)
            return 1
        return run_multihost(args, False, "dbscan", device)
    if not args.use_device:
        print("ERROR: rabbittclust_tpu_torch runs the device engine only: "
              "pass --device (the host engine is rabbittclust_tpu's "
              "clust-dbscan)", file=sys.stderr)
        return 1
    device = resolve_device(device)
    if not args.is_fast:
        if args.minhash_dbscan:
            return _minhash_main(args, stats)
        print("ERROR: clust-dbscan requires --fast option", file=sys.stderr)
        return 1
    print("-----Using DBSCAN clustering", file=sys.stderr)
    print(f"-----DBSCAN parameters: eps={args.eps}, minPts={args.minpts}",
          file=sys.stderr)
    if not (0 <= args.drlevel <= 8):
        print(f"ERROR: invalid drlevel {args.drlevel}, should be in [0, 8]",
              file=sys.stderr)
        return 1
    if args.append:
        print("ERROR: --append not supported for DBSCAN clustering",
              file=sys.stderr)
        return 1

    if args.presketched:
        from ..state.sketch_io import load_kssd_sketches
        ss, kp = load_kssd_sketches(args.presketched)
        # from-sketch: the reference derives k from the sketch params
        # (kmer_size = info.half_k * 2, sub_command.cpp:3247)
        cluster_kmer = kp.kmer_size
    else:
        if not args.input:
            print("ERROR: -i/--input or --presketched needed",
                  file=sys.stderr)
            return 1
        kmer_size = args.kmer_size or 19
        tuned = wf.tune_kssd_parameters(
            args.sketch_by_file, args.kmer_size is not None, args.input,
            args.threads, args.min_len, False, kmer_size, args.eps,
            args.drlevel)
        from ..io.fasta import read_file_list
        from ..sketch.kssd import sketch_files_kssd, sketch_sequences_kssd
        if args.sketch_by_file:
            ss, kp = sketch_files_kssd(read_file_list(args.input),
                                       args.min_len, tuned.kmer_size,
                                       args.drlevel, args.threads)
        else:
            ss, kp = sketch_sequences_kssd(args.input, args.min_len,
                                           tuned.kmer_size, args.drlevel,
                                           args.threads)
        # from-genome: the reference clusters with the RAW (tuned) CLI k
        # even though KSSD sketched with the rounded-even 2*half_k
        # (KssdDBSCAN receives kmerSize verbatim, sub_command.cpp:3281)
        cluster_kmer = tuned.kmer_size
    print(f"-----the size of sketches (genomes) is: {len(ss)}",
          file=sys.stderr)
    t0 = time.perf_counter()
    result = dbscan_cluster(ss.hashes, args.eps, args.minpts, cluster_kmer,
                            knn_k=args.knn_k, max_posting=args.max_posting,
                            use_device=True, device=device)
    if stats is not None:
        stats["dbscan_s"] = time.perf_counter() - t0
    write_dbscan_result(result, ss, args.output, args.eps, args.minpts)
    print(f"-----write the cluster result into: {args.output}",
          file=sys.stderr)
    print(f"-----clusters: {result.num_clusters}, noise: "
          f"{result.num_noise}", file=sys.stderr)
    return 0


# Source: rabbittclust_tpu/cli/clust_dbscan.py::_minhash_main
def _minhash_main(args, stats: Optional[dict] = None) -> int:
    """DBSCAN over MinHash sketches (the reference's latent MinHashDBSCAN
    engine, dbscan.cpp:987-1097), on the host as in the JAX package."""
    from ..sketch.minhash import (MinHashParams, sketch_files_minhash,
                                  sketch_sequences_minhash)
    from ..cluster.dbscan import minhash_dbscan_cluster
    from ..io.fasta import read_file_list

    print("-----Using DBSCAN clustering (MinHash)", file=sys.stderr)
    print(f"-----DBSCAN parameters: eps={args.eps}, minPts={args.minpts}",
          file=sys.stderr)
    kmer_size = args.kmer_size or 21
    sketch_size = args.sketch_size or 1000
    is_containment = args.contain_compress is not None
    p = MinHashParams(kmer_size=kmer_size, sketch_size=sketch_size,
                      is_containment=is_containment,
                      contain_compress=args.contain_compress or 1000)
    if args.sketch_by_file:
        ss = sketch_files_minhash(read_file_list(args.input), args.min_len,
                                  p, args.threads)
    else:
        ss = sketch_sequences_minhash(args.input, args.min_len, p,
                                      args.threads)
    print(f"-----the size of sketches (genomes) is: {len(ss)}",
          file=sys.stderr)
    t0 = time.perf_counter()
    result = minhash_dbscan_cluster(ss.hashes, args.eps, args.minpts,
                                    kmer_size, is_containment=is_containment)
    if stats is not None:
        stats["dbscan_s"] = time.perf_counter() - t0
    write_dbscan_result(result, ss, args.output, args.eps, args.minpts)
    print(f"-----write the cluster result into: {args.output}",
          file=sys.stderr)
    print(f"-----clusters: {result.num_clusters}, noise: "
          f"{result.num_noise}", file=sys.stderr)
    return 0


def cli() -> int:
    """Console entry with clean error reporting for bad inputs."""
    try:
        return main()
    except (FileNotFoundError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(cli())
