"""clust-leiden entry point of the port: the ``--device`` arms on an explicit
torch device (reference src/main.cpp:391-477 dispatch).

    python -m rabbittclust_tpu_torch.cli.clust_leiden --fast --device \\
        -l -i genomes.list -o out.cluster -d 0.05

KSSD (``--fast``), from genomes or ``--presketched``.  The similarity
graph's pairs come from the native host engine by default, as in the JAX
package under ``--device``; ``RTC_LEIDEN_DEVICE=force`` takes them from the
device filter (``ops/bitmap.py::candidate_pairs_threshold``: K1, and K3
under ``RTC_PULL_MODE=idx``).  Both give the same graph.  ``--pregraph``
re-clusters a saved graph on the host and, like clust-mst's
``--premsted``, needs no ``--device``.  ``--multihost`` runs one rank of
the multi-process graph build (``workflows_dist.py``), after the kNN
auto-selection.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import torch

from ..device import resolve_device
from ..cluster.leiden import cluster_graph, community_clusters, load_graph
from ..state.cluster_io import write_cluster_file
from .clust_mst import run_multihost
from .common import base_parser, validate_common


# Source: rabbittclust_tpu/cli/clust_leiden.py::main
def main(argv=None, device: Optional[torch.device] = None,
         stats: Optional[dict] = None) -> int:
    """``device=None`` requires CUDA; ``torch.device("cpu")`` runs the plain
    torch versions of the kernels.  ``stats``, when given, receives the
    seconds of the graph and the clustering (``leiden_s``)."""
    args = base_parser("leiden").parse_args(argv)
    validate_common(args, "leiden")

    use_louvain = args.use_louvain
    knn_k = args.knn_k
    if use_louvain and knn_k == 0:
        knn_k = 1000
        print(f"-----Auto-enabled: edge-parallel + warm-start + knn={knn_k}",
              file=sys.stderr)
    if knn_k == 0:
        knn_k = 500
        print(f"-----Auto-selecting k-NN: k={knn_k} (use --knn 0 to disable)",
              file=sys.stderr)
    if 0 < knn_k < 10:
        print(f"WARNING: --knn value too small ({knn_k}), recommend at "
              f"least 50. Using 50.", file=sys.stderr)
        knn_k = 50
    if args.multihost:
        # after the auto-kNN resolution: the multi-process graph prunes
        # with the k the single-process run auto-selects
        args.knn_k = knn_k
        return run_multihost(args, False, "leiden", device)

    if args.pregraph:
        if os.path.isdir(args.pregraph):
            # reference semantics (sub_command.cpp:3200-3226): the argument
            # is a sketch folder; the graph lives at <folder>/leiden.graph
            # and sketches supply the genome metadata for the output rows
            from ..state.sketch_io import load_kssd_sketches
            ss, _ = load_kssd_sketches(args.pregraph)
            print(f"-----the size of sketches is: {len(ss)}", file=sys.stderr)
            n, graph = load_graph(
                os.path.join(args.pregraph, "leiden.graph"))
            clusters = cluster_graph(n, graph, args.resolution,
                                     not use_louvain)
            write_cluster_file(args.output, clusters, ss, args.threshold)
        else:
            # a bare graph file: no sketch metadata, so rows carry ids only
            n, graph = load_graph(args.pregraph)
            clusters = cluster_graph(n, graph, args.resolution,
                                     not use_louvain)
            _write_membership(clusters, args.output)
        print(f"-----write the cluster result into: {args.output}",
              file=sys.stderr)
        return 0

    if not args.use_device:
        print("ERROR: rabbittclust_tpu_torch runs the device engine only: "
              "pass --device (the host engine is rabbittclust_tpu's "
              "clust-leiden)", file=sys.stderr)
        return 1
    device = resolve_device(device)
    if not args.is_fast:
        print("ERROR: clust-leiden requires --fast option", file=sys.stderr)
        return 1

    folder = None
    if args.presketched:
        from ..state.sketch_io import load_kssd_sketches
        ss, kp = load_kssd_sketches(args.presketched)
        folder = args.presketched
        # from-sketch: k derives from the sketch params (half_k * 2,
        # reference sub_command.cpp:3173)
        cluster_kmer = kp.kmer_size
    else:
        if not args.input:
            print("ERROR: -i/--input or --presketched needed",
                  file=sys.stderr)
            return 1
        kmer_size = args.kmer_size or 19
        # from-genome: the reference passes the RAW CLI k to
        # KssdLeidenCluster's distance math even though KSSD sketched
        # with the rounded-even 2*half_k (sub_command.cpp:3144)
        cluster_kmer = kmer_size
        if not (0 <= args.drlevel <= 8):
            print(f"ERROR: invalid drlevel {args.drlevel}, should be in "
                  f"[0, 8]", file=sys.stderr)
            return 1
        from ..io.fasta import read_file_list
        from ..sketch.kssd import sketch_files_kssd, sketch_sequences_kssd
        if args.sketch_by_file:
            ss, kp = sketch_files_kssd(read_file_list(args.input),
                                       args.min_len, kmer_size, args.drlevel,
                                       args.threads)
        else:
            ss, kp = sketch_sequences_kssd(args.input, args.min_len,
                                           kmer_size, args.drlevel,
                                           args.threads)
    print(f"-----the size of sketches (genomes) is: {len(ss)}",
          file=sys.stderr)
    graph_path = None
    if not args.no_save:
        # save sketches to a run folder (reference compute_kssd_sketches,
        # sub_command.cpp:3121) and the graph as <folder>/leiden.graph so
        # --pregraph <folder> works for fast resolution sweeps
        from ..state import sketch_io
        if folder is None:
            folder = sketch_io.default_folder_path()
            sketch_io.ensure_folder(folder)
            sketch_io.save_kssd_sketches(ss, kp, folder)
            sketch_io.save_kssd_index(ss.hashes, ss.use64, folder)
        graph_path = os.path.join(folder, "leiden.graph")
    # --louvain auto-enables the edge-parallel warm-start path
    # (reference main.cpp:403-414)
    t0 = time.perf_counter()
    clusters = community_clusters(
        ss.hashes, args.threshold, cluster_kmer, args.resolution,
        use_leiden=not use_louvain, knn_k=knn_k,
        graph_save_path=graph_path, use_device=True,
        edge_parallel=use_louvain, device=device)
    if stats is not None:
        stats["leiden_s"] = time.perf_counter() - t0
    write_cluster_file(args.output, clusters, ss, args.threshold)
    print(f"-----write the cluster result into: {args.output}",
          file=sys.stderr)
    return 0


# Source: rabbittclust_tpu/cli/clust_leiden.py::_write_membership
def _write_membership(clusters, output: str) -> None:
    with open(output, "w") as f:
        f.write("# Clustering from pre-built graph\n")
        f.write(f"# Total clusters: {len(clusters)}\n#\n")
        for ci, members in enumerate(clusters):
            f.write(f"the cluster {ci} is: \n")
            for li, gid in enumerate(members):
                f.write(f"\t{li:5d}\t{gid:6d}\n")
            f.write("\n")


def cli() -> int:
    """Console entry with clean error reporting for bad inputs."""
    try:
        return main()
    except (FileNotFoundError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(cli())
