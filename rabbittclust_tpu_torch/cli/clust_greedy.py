"""clust-greedy entry point of the port: the ``--device`` arms on an explicit
torch device (reference src/main.cpp:291-390 dispatch).

    python -m rabbittclust_tpu_torch.cli.clust_greedy --fast --device \\
        -l -i genomes.list -o out.cluster -d 0.05

KSSD (``--fast``) and MinHash, from genomes or ``--presketched``, run on
the device sweep of ``ops/greedy_device.py`` (KSSD under
``RTC_GREEDY_DEVICE``: ``auto`` probes the corpus density and may take the
native engine, ``native`` always does, ``force`` never); ``--save-rep``
writes ``cluster_state.bin``.  ``--append`` runs the incremental state
machine on the host (``workflows.append_clust_greedy_fast``; MinHash:
``workflows_minhash_append.append_clust_greedy``, whose classic mode
re-clusters on the device and alone needs ``--device``), as the JAX
package does.  ``--db`` runs the greedy RepDB verbs (``cli/repdb.py``,
with or without ``--device``: the KSSD ``--query`` on the CLI's device,
the others on the host; with ``--multihost`` each rank probes its block
of the queries on the host).
``--multihost`` otherwise runs one rank of the multi-process greedy
(``workflows_dist.py``).
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from ..device import resolve_device
from .. import workflows as wf
from .clust_mst import run_multihost
from .common import base_parser, make_output_options, validate_common


# Source: rabbittclust_tpu/cli/clust_greedy.py::main
def main(argv=None, device: Optional[torch.device] = None,
         stats: Optional[dict] = None) -> int:
    """``device=None`` requires CUDA; ``torch.device("cpu")`` runs the plain
    torch versions of the kernels.  ``stats``, when given, receives the
    greedy phase's seconds and route (``workflows._greedy_clusters``,
    ``compute_minhash_clusters``)."""
    args = base_parser("greedy").parse_args(argv)
    validate_common(args, "greedy")
    opts = make_output_options(args)
    is_containment = args.contain_compress is not None
    module = "greedy"

    if args.sketch_func in ("WMH", "HLL", "OMH"):
        # reference greedy explicitly rejects these (greedy.cpp:313-317)
        print("can only support MinHash and KSSD with greedy incremental "
              "clust", file=sys.stderr)
        return 1
    if args.repdb_path:
        from .repdb import run_greedy_repdb
        return run_greedy_repdb(args, opts, device)
    if args.multihost:
        return run_multihost(args, is_containment, module, device)
    if args.append and not args.presketched:
        print("ERROR option --append, option --presketched needed",
              file=sys.stderr)
        return 1
    host_append = bool(args.append) and wf.append_on_host(
        args.presketched, "greedy", args.is_fast)
    if not (args.use_device or host_append):
        print("ERROR: rabbittclust_tpu_torch runs the device engine only: "
              "pass --device (the host engine is rabbittclust_tpu's "
              "clust-greedy)", file=sys.stderr)
        return 1
    if not host_append:
        device = resolve_device(device)
    if args.append:
        if args.is_fast:
            wf.append_clust_greedy_fast(args.presketched, args.append,
                                        args.output, args.sketch_by_file,
                                        args.min_len, args.threshold,
                                        args.threads, opts)
        else:
            from ..workflows_minhash_append import append_clust_greedy
            append_clust_greedy(args.presketched, args.append, args.output,
                                args.sketch_by_file, args.min_len,
                                args.threshold, args.threads, opts, device,
                                stats)
        return 0
    if args.presketched:
        if args.is_fast:
            wf.clust_from_sketch_fast(args.presketched, args.output,
                                      args.threshold, args.threads,
                                      is_containment, opts, device, stats,
                                      module)
        else:
            wf.clust_from_sketches(args.presketched, args.output,
                                   args.threshold, args.threads, opts,
                                   device, stats, module)
        return 0
    if not args.input:
        print("ERROR: -i/--input or --presketched needed", file=sys.stderr)
        return 1
    if args.is_fast:
        tuned = wf.tune_kssd_parameters(
            args.sketch_by_file, args.kmer_size is not None, args.input,
            args.threads, args.min_len, is_containment,
            args.kmer_size or 19, args.threshold, args.drlevel)
        wf.clust_from_genome_fast(
            args.input, args.output, None, args.sketch_by_file,
            is_containment, tuned.kmer_size, args.threshold, args.drlevel,
            args.min_len, args.threads, opts, device, stats, module)
        return 0
    tuned = wf.tune_parameters(
        args.sketch_by_file, args.kmer_size is not None, args.input,
        args.threads, args.min_len, is_containment,
        args.sketch_size is not None, args.kmer_size or 21, args.threshold,
        args.contain_compress or 1000, args.sketch_size or 1000,
        greedy_default_containment=True)
    wf.clust_from_genomes(
        args.input, args.output, None, args.sketch_by_file, tuned.kmer_size,
        args.sketch_size or 1000, args.threshold, tuned.is_containment,
        tuned.contain_compress, args.min_len, args.threads, opts, device,
        stats, module)
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
