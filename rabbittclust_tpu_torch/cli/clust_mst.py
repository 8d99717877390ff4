"""clust-mst entry point of the port: the ``--fast --device`` arms on an
explicit torch device.

    python -m rabbittclust_tpu_torch.cli.clust_mst --fast --device \\
        -l -i genomes.list -o out.cluster -d 0.05

The flags are the shared parser's (``rabbittclust_tpu/cli/common.py``).
Arms not ported yet exit with status 1 and name the ROADMAP item that will
port them; none of them falls back to the JAX package.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from ..device import resolve_device
from ..host import (base_parser, make_output_options, shared_wf,
                    validate_common)
from .. import workflows as wf

# (predicate on the parsed args, what it is, ROADMAP Queue 1 item)
_NOT_PORTED = [
    (lambda a: a.sketch_func != "MinHash", "--sketch-func WMH/HLL/OMH", 8),
    (lambda a: a.repdb_path, "--db (RepDB)", 11),
    (lambda a: a.multihost, "--multihost", 10),
    (lambda a: not a.is_fast, "the MinHash arm (no --fast)", 11),
    (lambda a: a.build_db, "--buildDB", 11),
    (lambda a: a.append, "--append", 5),
    (lambda a: a.save_rep, "--save-rep state files", 11),
]


def main(argv=None, device: Optional[torch.device] = None,
         stats: Optional[dict] = None) -> int:
    """``device=None`` requires CUDA; ``torch.device("cpu")`` runs the plain
    torch versions of the kernels.  ``stats``, when given, receives the
    run's phase times and counts (see ``ops.engine.compute_mst_device``)."""
    args = base_parser("mst").parse_args(argv)
    validate_common(args, "mst")
    opts = make_output_options(args, "mst")
    is_containment = args.contain_compress is not None

    for applies, what, item in _NOT_PORTED:
        if applies(args):
            print(f"ERROR: {what} is not ported to rabbittclust_tpu_torch "
                  f"yet (ROADMAP Queue 1 item {item})", file=sys.stderr)
            return 1
    if args.premsted:
        wf.clust_from_mst_fast(args.premsted, args.output, args.threshold,
                               args.threads, opts)
        return 0
    if not args.use_device:
        print("ERROR: rabbittclust_tpu_torch runs the device engine only: "
              "pass --device (the host engine is rabbittclust_tpu's "
              "clust-mst)", file=sys.stderr)
        return 1
    device = resolve_device(device)
    if args.presketched:
        wf.clust_from_sketch_fast(args.presketched, args.output,
                                  args.threshold, is_containment, opts,
                                  device, stats)
        return 0
    if not args.input:
        print("ERROR: -i/--input or --presketched needed", file=sys.stderr)
        return 1
    tuned = shared_wf.tune_kssd_parameters(
        args.sketch_by_file, args.kmer_size is not None, args.input,
        args.threads, args.min_len, is_containment, args.kmer_size or 19,
        args.threshold, args.drlevel)
    wf.clust_from_genome_fast(
        args.input, args.output, None, args.sketch_by_file, is_containment,
        tuned.kmer_size, args.threshold, args.drlevel, args.min_len,
        args.threads, opts, device, stats)
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
