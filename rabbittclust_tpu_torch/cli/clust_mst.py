"""clust-mst entry point of the port: the ``--device`` arms on an explicit
torch device (reference src/main.cpp:524-651 dispatch).

    python -m rabbittclust_tpu_torch.cli.clust_mst --fast --device \\
        -l -i genomes.list -o out.cluster -d 0.05

The flags are the reference's (``cli/common.py``, a copy of the JAX
package's parser).  Every arm of the JAX CLI runs: KSSD (``--fast``: fresh
genomes, ``--presketched``, ``--premsted``, ``--append`` classic or over a
saved ``mst_cluster_state.bin``, ``--save-rep``, ``--buildDB``), MinHash
(no ``--fast``: the same, ``workflows_minhash_append.py`` for
``--append``), the MST RepDB verbs (``--db``, ``cli/repdb.py``),
``--sketch-func WMH|HLL|OMH`` (fresh genomes; WMH and OMH on the card with
or without ``--device``) and ``--multihost`` (``run_multihost``: one rank
of a multi-process run, ``workflows_dist.py``).  The clustering arms need
``--device``.  ``--premsted``, ``--buildDB``, an ``--append`` through a
saved state and the RepDB verbs run without it: on the host where the JAX
package does, but for the RepDB ``--build``, which takes the dense engine
on the CLI's device either way.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from ..device import resolve_device
from .. import workflows as wf
from .common import base_parser, make_output_options, validate_common


def main(argv=None, device: Optional[torch.device] = None,
         stats: Optional[dict] = None) -> int:
    """``device=None`` requires CUDA; ``torch.device("cpu")`` runs the plain
    torch versions of the kernels.  ``stats``, when given, receives the
    run's phase times and counts (see ``ops.engine.compute_mst_device``;
    ``clusters_s`` for the MST-free ``-e`` engines, whose phases are in
    ``ops.labelprop.LP_STATS``)."""
    args = base_parser("mst").parse_args(argv)
    validate_common(args, "mst")
    opts = make_output_options(args)
    is_containment = args.contain_compress is not None

    if args.sketch_func in ("WMH", "HLL", "OMH"):
        return _extra_sketch_arm(args, device, stats)
    if args.repdb_path:
        from .repdb import run_mst_repdb
        return run_mst_repdb(args, opts, device)
    if args.multihost:
        return run_multihost(args, is_containment, "mst", device)
    if args.is_fast and args.build_db:
        # Source: rabbittclust_tpu/cli/clust_mst.py::main (the --buildDB arm)
        if not args.sketch_by_file:
            print("ERROR: --buildDB currently requires -l/--list",
                  file=sys.stderr)
            return 1
        if not args.input:
            print("ERROR: --buildDB requires -i/--input", file=sys.stderr)
            return 1
        from ..workflows_db import build_kssd_db_fast
        build_kssd_db_fast(args.input, args.build_db,
                           args.kmer_size is not None, is_containment,
                           args.min_len, args.kmer_size or 21,
                           args.drlevel, args.threads)
        return 0
    if args.premsted and not args.append:
        # MinHash runs omit the threshold header (kssd=False)
        wf.clust_from_mst_fast(args.premsted, args.output, args.threshold,
                               args.threads, opts, kssd=args.is_fast)
        return 0
    if args.append and not (args.presketched or args.premsted):
        print("ERROR: option --append, option --presketched or "
              "--premsted needed", file=sys.stderr)
        return 1
    host_append = bool(args.append) and wf.append_on_host(
        args.presketched or args.premsted, "mst", args.is_fast)
    if not (args.use_device or host_append):
        print("ERROR: rabbittclust_tpu_torch runs the device engine only: "
              "pass --device (the host engine is rabbittclust_tpu's "
              "clust-mst)", file=sys.stderr)
        return 1
    if not host_append:
        device = resolve_device(device)
    if args.is_fast:
        if args.append:
            wf.append_clust_mst_fast(args.presketched or args.premsted,
                                     args.append, args.output,
                                     args.sketch_by_file, is_containment,
                                     args.min_len, args.threshold,
                                     args.threads, opts, device, stats)
            return 0
        if args.presketched:
            wf.clust_from_sketch_fast(args.presketched, args.output,
                                      args.threshold, args.threads,
                                      is_containment, opts, device, stats)
            return 0
        if not args.input:
            print("ERROR: -i/--input or --presketched needed",
                  file=sys.stderr)
            return 1
        tuned = wf.tune_kssd_parameters(
            args.sketch_by_file, args.kmer_size is not None, args.input,
            args.threads, args.min_len, is_containment, args.kmer_size or 19,
            args.threshold, args.drlevel)
        wf.clust_from_genome_fast(
            args.input, args.output, None, args.sketch_by_file,
            is_containment, tuned.kmer_size, args.threshold, args.drlevel,
            args.min_len, args.threads, opts, device, stats)
        return 0

    # MinHash (default) arm
    if args.append:
        from ..workflows_minhash_append import append_clust_mst
        append_clust_mst(args.presketched or args.premsted, args.append,
                         args.output, args.sketch_by_file, args.min_len,
                         args.threshold, args.threads, opts, device, stats)
        return 0
    if args.presketched:
        wf.clust_from_sketches(args.presketched, args.output, args.threshold,
                               args.threads, opts, device, stats)
        return 0
    if not args.input:
        print("ERROR: -i/--input or --presketched needed", file=sys.stderr)
        return 1
    tuned = wf.tune_parameters(
        args.sketch_by_file, args.kmer_size is not None, args.input,
        args.threads, args.min_len, is_containment,
        args.sketch_size is not None, args.kmer_size or 21, args.threshold,
        args.contain_compress or 1000, args.sketch_size or 1000)
    wf.clust_from_genomes(
        args.input, args.output, None, args.sketch_by_file, tuned.kmer_size,
        args.sketch_size or 1000, args.threshold, tuned.is_containment,
        tuned.contain_compress, args.min_len, args.threads, opts, device,
        stats)
    return 0


# Source: rabbittclust_tpu/cli/clust_mst.py::main (the extra sketch arm)
def _extra_sketch_arm(args, device: Optional[torch.device],
                      stats: Optional[dict]) -> int:
    """``--sketch-func WMH|HLL|OMH``: the dense all-pairs modifyMST path
    (latent in the reference), fresh genome input only.  WMH and OMH take
    the card whether or not ``--device`` is given; HLL stays on the
    host."""
    if args.is_fast or args.repdb_path or args.presketched \
            or args.premsted or args.append:
        print("ERROR: --sketch-func WMH/HLL/OMH supports fresh genome "
              "input only (no --fast/--db/--presketched/--premsted/"
              "--append)", file=sys.stderr)
        return 1
    if not args.input:
        print("ERROR: -i/--input needed", file=sys.stderr)
        return 1
    from ..workflows_extra import clust_from_genomes_extra
    if args.sketch_func != "HLL":
        device = resolve_device(device)
    clust_from_genomes_extra(
        args.input, args.output, args.sketch_by_file, args.sketch_func,
        args.kmer_size or 21, args.threshold, args.min_len, device, stats)
    return 0


# Source: rabbittclust_tpu/cli/clust_mst.py::run_multihost
def run_multihost(args, is_containment: bool, module: str,
                  device: Optional[torch.device] = None) -> int:
    """Shared --multihost dispatch for clust-mst/clust-greedy/clust-leiden/
    clust-dbscan (KSSD fresh-genome input): this process is one rank of
    ``workflows_dist.clust_mst_multihost``.  Its shards: ``[device]`` when
    the caller passes one, else ``parallel.multihost.local_devices`` (its
    card, or ``RTC_VIRTUAL_CPU_DEVICES=M`` CPU shards)."""
    if not args.is_fast:
        print("ERROR: --multihost requires --fast (KSSD sketches)",
              file=sys.stderr)
        return 1
    if not args.input:
        print("ERROR: --multihost requires -i/--input genomes",
              file=sys.stderr)
        return 1
    if args.presketched or getattr(args, "premsted", None) or args.append:
        print("ERROR: --multihost supports fresh genome input only",
              file=sys.stderr)
        return 1
    from ..workflows_dist import clust_mst_multihost, parse_multihost_spec
    coord, n_proc, pid = parse_multihost_spec(args.multihost)
    # clust-dbscan spells its distance threshold --eps
    threshold = args.eps if module == "dbscan" else args.threshold
    clust_mst_multihost(
        args.input, args.output, coord, n_proc, pid,
        sketch_by_file=args.sketch_by_file, is_containment=is_containment,
        kmer_size=args.kmer_size, threshold=threshold,
        drlevel=args.drlevel, min_len=args.min_len, threads=args.threads,
        module=module, min_pts=getattr(args, "minpts", 5),
        max_posting=getattr(args, "max_posting", 0),
        resolution=getattr(args, "resolution", 1.0),
        use_leiden=not getattr(args, "use_louvain", False),
        knn_k=getattr(args, "knn_k", 0),
        devices=None if device is None else [device])
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
