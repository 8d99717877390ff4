"""The port's multi-device dry run (counterpart of
``__graft_entry__.py::dryrun_multichip``): one pass over every mesh
program on ``n_devices`` shards, then the two-process simulation.

    python -m rabbittclust_tpu_torch.parallel.dryrun 4          # the card
    python -m rabbittclust_tpu_torch.parallel.dryrun 4 --cpu    # CPU shards

On the card the shards repeat the visible GPUs (``[cuda:0] * 4`` on a
one-card machine: the shards run one after another, so the run checks the
programs, not multi-GPU speed).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.pack import pack_sketches
from . import dist_engine as de
from .multihost import launch_local_sim


def dryrun_corpus(n_devices: int):
    """``__graft_entry__``'s tiny clustered corpus: 8 genomes a shard."""
    rng = np.random.default_rng(0)
    n, s = 8 * n_devices, 50
    base = np.unique(rng.integers(0, 2 ** 28, size=s).astype(np.uint32))
    hashes = []
    for _ in range(n):
        keep = base[rng.random(len(base)) < 0.8]
        extra = np.unique(rng.integers(0, 2 ** 28, size=s).astype(np.uint32))[
            : s - len(keep)]
        hashes.append(np.unique(np.concatenate([keep, extra])))
    return hashes


# Source: __graft_entry__.py::dryrun_multichip
def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """The stats ring, the exact ring's MST at 32 and 64 bits, the
    similarity graph, the bitmap and exact threshold clusters and the mesh
    LP over a mesh of ``n_devices`` shards (by default the visible cards,
    repeated), then for ``n_devices >= 2`` two processes of
    ``n_devices // 2`` shards each (``launch_local_sim``) with equal
    digests.  Prints JAX's summary line and returns its numbers."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip needs a CUDA GPU and "
                               "torch.cuda.is_available() is false; pass "
                               "devices= for CPU shards")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    mesh = de.make_mesh(n_devices, devices=devices)
    assert mesh.size >= n_devices, (
        f"need {n_devices} devices, have {mesh.size}")
    hashes = dryrun_corpus(n_devices)
    n = len(hashes)
    packed = pack_sketches(hashes, use64=False, pad_n_to=n)
    total, min_d = de.distributed_candidate_stats(
        packed.plane0[:n], packed.sizes[:n], threshold=0.05, kmer_size=20,
        mesh=mesh)
    assert total >= 0 and 0.0 <= min_d <= 1.0
    res = de.distributed_mst(hashes, 0.05, 20, mesh=mesh)
    assert len(res.mst[0]) > 0
    frm, _to, _w = de.distributed_similarity_graph(hashes, 0.05, 20,
                                                   mesh=mesh)
    h64 = [h.astype(np.uint64) for h in hashes]
    res64 = de.distributed_mst(h64, 0.05, 20, mesh=mesh)
    e32 = sorted((min(a, b), max(a, b)) for a, b in zip(*res.mst[:2]))
    e64 = sorted((min(a, b), max(a, b)) for a, b in zip(*res64.mst[:2]))
    assert e32 == e64, "64-bit ring must find the same MST edge set"
    cb = de.distributed_threshold_clusters(hashes, 0.05, 20, mesh=mesh,
                                           bits=1024)
    ce = de.distributed_threshold_clusters(hashes, 0.05, 20, mesh=mesh,
                                           engine="exact")
    assert sorted(sorted(c) for c in cb) == sorted(sorted(c) for c in ce), \
        "bitmap-ring clusters must match the exact ring"
    clp = de.distributed_threshold_clusters_lp(hashes, 0.05, 20, mesh=mesh,
                                               bits=1024)
    assert sorted(sorted(c) for c in clp) == sorted(sorted(c) for c in ce), \
        "mesh labelprop clusters must match the exact ring"
    mh_msg = "skipped (n_devices < 2)"
    outs = []
    if n_devices >= 2:
        outs = launch_local_sim(num_processes=2,
                                devices_per_proc=n_devices // 2,
                                n_genomes=48,
                                device="cuda" if mesh.cuda else "cpu")
        digests = {o.split("digest=")[1] for o in outs}
        assert len(digests) == 1, outs
        mh_msg = f"2 procs x {n_devices // 2} devs OK"
    print(f"dryrun_multichip({n_devices}): candidate pairs <= d: {total}, "
          f"min distance: {min_d:.4f}, distributed MST edges: "
          f"{len(res.mst[0])} (u32==u64), leiden graph edges: {len(frm)}, "
          f"bitmap-ring clusters: {len(cb)}, mesh-labelprop clusters: "
          f"{len(clp)}, multihost: {mh_msg}", flush=True)
    return {"total": total, "min_d": min_d, "mst_edges": len(res.mst[0]),
            "graph_edges": len(frm), "bitmap_clusters": len(cb),
            "lp_clusters": len(clp), "sim": outs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU shards (the plain versions of the kernels)")
    args = ap.parse_args(argv)
    devices = [torch.device("cpu")] * args.n_devices if args.cpu else None
    dryrun_multichip(args.n_devices, devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
