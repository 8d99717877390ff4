"""Multi-process mesh over ``torch.distributed`` (counterpart of
``rabbittclust_tpu/parallel/multihost.py``).

The JAX layer is one program a host: each process owns its local chips,
one 1-D "data" mesh spans every chip of every process, the ring's
``ppermute`` hops ride ICI or DCN and host data moves by
``process_allgather``.  Here:

* one process a card (or, for a simulation, M logical shards in one
  process); ``init_multihost`` joins the processes with
  ``torch.distributed`` and ``global_mesh`` is a small record of this
  process's shards, its rank and the world size.  Local shard i is global
  shard ``rank * per_proc + i`` (every process holds the same number of
  shards).
* genomes are data-parallel across processes in contiguous global-id
  blocks (``shard_bounds``); each process packs only its block's
  signatures and splits it into its local shards.
* the ring is ``dist_engine._ring``, the single-process driver, with a
  shift that moves each local shard one place and sends the last one to
  rank + 1 while it receives rank - 1's last one, both in one
  ``batch_isend_irecv`` (no pair of ranks can deadlock).  The ring is
  ``dist_engine.ring_slabs`` (the ring step's kernel into each local
  shard's slab, its count on the device), closed by
  ``dist_engine.ring_positions``
  (one pull of the counts, one K3 launch, one pull of the positions a
  shard).
* host data (sketches, metadata, edge forests) moves by an allgather of
  uint8 CPU tensors over a gloo group: float64 and uint64 payloads arrive
  bit-exact.

The transport of the ring's hop is chosen from the layout alone, before
any collective of the ring (``init_multihost``): NCCL when every shard of
every rank lives on a distinct CUDA card (compared by
``torch.cuda.get_device_properties(d).uuid``); gloo with host staging when
ranks share a card (NCCL refuses two ranks on one GPU; gloo's send and
recv take CPU tensors, so a shard goes device -> pinned host -> send, then
recv -> pinned host -> device); gloo on CPU shards.  Nothing falls back
from one transport to another.

Exactness: the ring covers every global pair exactly once (triangular
schedule), the bitmap bound has no false negatives, verification uses the
native two-pointer kernel and float64 distances, so the partition equals
the single-host engine's bit-exactly.

Launching: one process per card with
``init_multihost("host0:8476", num_processes=N, process_id=i)`` (or the
CLIs' ``--multihost host0:8476,N,i``; ``parallel/launch.py`` starts N of
them on one machine).  ``RTC_VIRTUAL_CPU_DEVICES=M`` asks for M CPU shards
a process (the plain versions); without it a process takes
``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK`` defaults to the
process id) and raises when there is no GPU.  ``launch_local_sim`` spawns
N local processes running the self-test ``_sim_child``.

RepDB serving (``multihost_repdb_query``, ``multihost_repdb_assign``):
each process probes its block of the queries against its replica of the
state on the host and the hits are allgathered, as in the JAX package.

Left out: the JAX function's ``cap`` (each step's output is sized from
the step's count).
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..distance.mash import (aaf_distance, mash_distance,
                             min_jaccard_for_threshold, size_ratio_limit)
from ..ops import bitmap as bm
from . import dist_engine as de

# the process group's timeout: long enough for a rank that sketches or
# verifies while the others wait at a collective, short of torch's 30 min
TIMEOUT_S = 600.0

# the last multi-process ring of this process: its transport, the bytes and
# milliseconds of each hop (staging included), of each ring step (into the
# slab) and of each local shard's close (its pulls and K3)
RING_LAST: dict = {}


@dataclass(frozen=True)
class GlobalMesh:
    """This process's part of the global 1-D mesh: its shards' devices
    (``per_proc`` of them, a device may repeat), its rank, the world size
    and the ring's transport ("nccl", "gloo-staged" or "gloo")."""
    devices: Tuple[torch.device, ...]
    rank: int
    world: int
    transport: str

    @property
    def per_proc(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.world * self.per_proc

    @property
    def cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    @property
    def global_shards(self) -> Tuple[int, ...]:
        """The global index of each local shard: rank * per_proc + i."""
        return tuple(self.rank * self.per_proc + i
                     for i in range(self.per_proc))


_STATE: dict = {"mesh": None, "ring_group": None}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def local_devices(process_id: int, shards: int = 1) -> List[torch.device]:
    """The shards' devices of a launched process: ``[cpu] * M`` under
    ``RTC_VIRTUAL_CPU_DEVICES=M``, else ``shards`` times the card
    ``cuda:(LOCAL_RANK % device_count)``; raises when there is no GPU."""
    virtual = os.environ.get("RTC_VIRTUAL_CPU_DEVICES")
    if virtual:
        return [torch.device("cpu")] * int(virtual)
    if not torch.cuda.is_available():
        raise RuntimeError("a multi-process run needs a CUDA GPU and "
                           "torch.cuda.is_available() is false (set "
                           "RTC_VIRTUAL_CPU_DEVICES=M for M CPU shards a "
                           "process)")
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    card = torch.device("cuda", local_rank % torch.cuda.device_count())
    return [card] * shards


def _describe(devices: Sequence[torch.device]) -> List[Tuple[str, str]]:
    return [(d.type, str(torch.cuda.get_device_properties(d).uuid)
             if d.type == "cuda" else "") for d in devices]


def _transport(layout: List[List[Tuple[str, str]]]) -> str:
    """The ring's transport from every rank's (type, uuid) per shard."""
    types = {t for proc in layout for t, _ in proc}
    if len(types) != 1:
        raise ValueError(f"the shards of a multi-process mesh are all CUDA "
                         f"or all CPU, got {sorted(types)}")
    if types == {"cpu"}:
        return "gloo"
    uuids = [u for proc in layout for _, u in proc]
    return "nccl" if len(set(uuids)) == len(uuids) else "gloo-staged"


# Source: rabbittclust_tpu/parallel/multihost.py::init_multihost
def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int,
                   devices: Optional[Sequence] = None,
                   timeout_s: float = TIMEOUT_S) -> GlobalMesh:
    """Join the ``torch.distributed`` processes (a gloo group for host
    data, and an NCCL group for the ring when every shard has a card of
    its own) and record this process's part of the global mesh.
    ``devices``: the shards' devices (by default ``local_devices``).
    Every process must hold the same number of shards."""
    devs = local_devices(process_id) if devices is None else \
        [resolve_device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if not devs:
        raise ValueError("a process of the mesh needs at least one shard")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout_s))
    layout: list = [None] * num_processes
    dist.all_gather_object(layout, _describe(devs))
    counts = [len(x) for x in layout]
    if len(set(counts)) != 1:
        shutdown_multihost()
        raise ValueError(
            f"the global mesh has {sum(counts)} devices across "
            f"{num_processes} processes — devices must divide evenly per "
            f"process; got {counts}")
    transport = _transport(layout)
    ring_group = None
    if transport == "nccl":
        torch.cuda.set_device(devs[0])
        ring_group = dist.new_group(backend="nccl",
                                    timeout=timedelta(seconds=timeout_s))
    mesh = GlobalMesh(tuple(devs), process_id, num_processes, transport)
    _STATE.update(mesh=mesh, ring_group=ring_group)
    _log(f"-----process {process_id}/{num_processes}: global shards "
         f"{list(mesh.global_shards)} on {devs[0]}, ring transport "
         f"{transport}")
    return mesh


def shutdown_multihost() -> None:
    """Leave the process groups (a no-op outside a multi-process run)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(mesh=None, ring_group=None)


# Source: rabbittclust_tpu/parallel/multihost.py::global_mesh
def global_mesh() -> GlobalMesh:
    """This process's part of the global mesh (``init_multihost`` first)."""
    if _STATE["mesh"] is None:
        raise RuntimeError("init_multihost has not run in this process")
    return _STATE["mesh"]


# Source: rabbittclust_tpu/parallel/multihost.py::shard_bounds
def shard_bounds(n_total: int, num_processes: int,
                 process_id: int) -> Tuple[int, int]:
    """Contiguous genome block [lo, hi) owned by ``process_id``.  Blocks
    follow the device-shard layout of a length-``n_pad`` array sharded over
    the global mesh: padding (if any) lands in the LAST process."""
    per = -(-n_total // num_processes)
    lo = min(process_id * per, n_total)
    return lo, min(lo + per, n_total)


# Source: rabbittclust_tpu/parallel/multihost.py::_allgather_ragged
def _allgather_ragged(local: np.ndarray) -> List[np.ndarray]:
    """Allgather 1-D arrays of DIFFERENT lengths across processes (lengths
    first, then pad to the global max, gather, trim).  Returns one array
    per process.  Gathers raw bytes (uint8 CPU tensors over the gloo
    group), so every dtype arrives bit-exact."""
    dt = local.dtype
    raw = np.ascontiguousarray(local).view(np.uint8).reshape(-1)
    assert len(raw) < (1 << 31)
    world = dist.get_world_size()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lens, torch.tensor([len(raw)], dtype=torch.int64))
    lens = [int(x) for x in lens]
    m = max(lens)
    if m == 0:
        return [np.empty(0, dtype=dt) for _ in range(world)]
    padded = torch.zeros(m, dtype=torch.uint8)
    padded[:len(raw)] = torch.from_numpy(raw.copy())
    parts = [torch.empty(m, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(parts, padded)
    return [parts[p][:lens[p]].numpy().copy().view(dt)
            for p in range(world)]


def _any_process(flag: bool) -> bool:
    return bool(np.concatenate(_allgather_ragged(
        np.array([int(flag)], dtype=np.int64))).max())


def _local_use64(local_hashes: List[np.ndarray]) -> bool:
    return _any_process(len(local_hashes) > 0 and
                        local_hashes[0].dtype == np.uint64)


# Source: rabbittclust_tpu/parallel/multihost.py::allgather_sketches
def allgather_sketches(local_hashes: List[np.ndarray],
                       use64: bool) -> List[np.ndarray]:
    """Gather every process's per-genome hash arrays, in process (= global
    id) order, so each host holds the full sketch store for verification."""
    dt = np.uint64 if use64 else np.uint32
    flat = (np.concatenate(local_hashes).astype(dt) if local_hashes
            else np.empty(0, dtype=dt))
    sizes = np.array([len(h) for h in local_hashes], dtype=np.int64)
    flats = _allgather_ragged(flat)
    sizess = _allgather_ragged(sizes)
    out: List[np.ndarray] = []
    for f, s in zip(flats, sizess):
        offs = np.zeros(len(s) + 1, dtype=np.int64)
        np.cumsum(s, out=offs[1:])
        out.extend(f[offs[g]:offs[g + 1]] for g in range(len(s)))
    return out


# ---------------------------------------------------------------------------
# The ring's hop between processes

def _pack_shard(shard: de.BitShard) -> torch.Tensor:
    """A shard as one uint8 tensor on its device: signatures, collisions,
    sizes and its first genome id (the receiver knows the shapes)."""
    lo = torch.tensor([shard.lo], dtype=torch.int64,
                      device=shard.xp.device).view(torch.uint8)
    return torch.cat([shard.xp.reshape(-1), shard.coll.view(torch.uint8),
                      shard.sizes.view(torch.uint8), lo])


def _unpack_shard(buf: torch.Tensor, like: de.BitShard) -> de.BitShard:
    rows, width = like.xp.shape
    a = rows * width
    b = a + 4 * rows
    return de.BitShard(buf[:a].view(rows, width), buf[a:b].view(torch.int32),
                       buf[b:b + 4 * rows].view(torch.int32),
                       int(buf[b + 4 * rows:].cpu().view(torch.int64)))


def _hop(mesh: GlobalMesh, shard: de.BitShard, record: dict,
         staging: dict) -> de.BitShard:
    """Send this process's last visiting shard to rank + 1 and receive
    rank - 1's, paired in one ``batch_isend_irecv``; returns the received
    shard on this process's first device.  With one rank it only moves.
    ``staging`` holds the ring's page-locked send and receive buffers."""
    home = mesh.devices[0]
    if mesh.world == 1:
        return shard.to(home)
    buf = _pack_shard(shard)
    staged = mesh.transport == "gloo-staged"
    if staged and "send" not in staging:
        # gloo's send and recv take CPU tensors: stage through page-locked
        # host buffers (the card's copies run at full rate from them),
        # allocated once a ring since every hop has the same size
        staging["send"], staging["recv"] = (
            torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=True)
            for _ in range(2))
    if mesh.cuda:
        torch.cuda.synchronize(buf.device)
    t0 = time.perf_counter()
    group = None
    if mesh.transport == "nccl":
        send = buf.to(home)
        recv = torch.empty_like(send)
        group = _STATE["ring_group"]
    elif staged:
        send, recv = staging["send"], staging["recv"]
        send.copy_(buf)
    else:
        send, recv = buf, torch.empty_like(buf)
    dst = (mesh.rank + 1) % mesh.world
    src = (mesh.rank - 1) % mesh.world
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        req.wait()
    if staged:
        recv = recv.to(home, non_blocking=True)
    if mesh.cuda:
        # the staged receive buffer is free again once its copy is done
        torch.cuda.synchronize(home)
    record["hop_ms"].append(1e3 * (time.perf_counter() - t0))
    record["hop_bytes"].append(int(buf.numel()))
    return _unpack_shard(recv, shard)


def _process_shift(mesh: GlobalMesh, record: dict):
    """``dist_engine._ring``'s shift over the processes: local shard i - 1
    moves to device i, the last one goes to the next process."""
    staging: dict = {}

    def shift(vis):
        head = _hop(mesh, vis[-1], record, staging)
        return [head] + [vis[i - 1].to(mesh.devices[i])
                         for i in range(1, len(vis))]
    return shift


# Source: rabbittclust_tpu/parallel/multihost.py::
# multihost_candidate_pairs_bitmap
def multihost_candidate_pairs_bitmap(
        local_hashes: List[np.ndarray], n_total: int, threshold: float,
        kmer_size: int, is_containment: bool = False, bits: int = 8192,
        radio: Optional[int] = None,
        mesh: Optional[GlobalMesh] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Bitmap-filter candidates over the global (multi-process) mesh.

    Each process passes only its own contiguous genome block; returns the
    candidate pairs (global ids, i > j, unverified) whose owning row shard
    lives on this process.  Union over processes = the exact single-host
    candidate set (dist_engine.distributed_candidate_pairs_bitmap).  Each
    shard's output is sized from K1's counts (no ``cap``)."""
    if mesh is None:
        mesh = global_mesh()
    n_proc, pid = mesh.world, mesh.rank
    lo, hi = shard_bounds(n_total, n_proc, pid)
    if len(local_hashes) != hi - lo:
        raise ValueError(
            f"process {pid} passed {len(local_hashes)} local sketches but "
            f"owns the global block [{lo}, {hi}) of n_total={n_total}; "
            f"slice the input with shard_bounds(n_total, {n_proc}, {pid})")
    # global row padding: every process block padded to the same length so
    # shards align (per a multiple of the process's shard count); a pad
    # row has size 0 and the id of the next process's genome there, and
    # only the size gate keeps it out
    per = -(-n_total // n_proc)
    per = -(-per // mesh.per_proc) * mesh.per_proc
    xp_l, coll_l = bm.pack_bitmaps_packed(local_hashes, bits=bits,
                                          pad_n_to=1)
    if xp_l.shape[0] < per:
        xp_l = np.vstack([xp_l, np.zeros((per - xp_l.shape[0], bits // 8),
                                         dtype=np.uint8)])
        coll_l = np.concatenate(
            [coll_l, np.zeros(per - len(coll_l), dtype=np.int32)])
    xp_l, coll_l = xp_l[:per], coll_l[:per]
    sizes_l = np.zeros(per, dtype=np.int32)
    sizes_l[:len(local_hashes)] = [len(h) for h in local_hashes]

    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    if radio is None:
        radio = size_ratio_limit(threshold, kmer_size - 1)
    scalars = (np.float32(j_min), np.float32(1.0 + j_min), np.float32(c_min))
    n_dev = mesh.size
    local = de.Mesh(mesh.devices)
    shards = de._bit_shards(xp_l, coll_l, sizes_l, local, first_id=lo)
    record = {"transport": mesh.transport, "hop_bytes": [], "hop_ms": [],
              "step_ms": [], "compact_ms": []}
    events = []

    def wrap(step):
        def timed(d, t, loc, vis):
            if mesh.cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            else:
                t0 = time.perf_counter()
            out = step(d, t, loc, vis)
            if mesh.cuda:
                ev[1].record()
                events.append(ev)
            else:
                record["step_ms"].append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    slabs, counts, los = de.ring_slabs(
        local, shards, scalars, radio, is_containment,
        shift=_process_shift(mesh, record), n_dev=n_dev, wrap=wrap,
        counter="ring_bitmap")
    ii_all, jj_all = [], []
    for d in range(len(shards)):
        ii, jj = de.ring_positions(slabs[d], counts[d], los[d], record)
        ii_all.append(ii)
        jj_all.append(jj)
    record["step_ms"].extend(a.elapsed_time(z) for a, z in events)
    RING_LAST.clear()
    RING_LAST.update(record, n_dev=n_dev)
    ii = np.concatenate(ii_all)
    jj = np.concatenate(jj_all)
    # canonical host orientation (i > j) — see the dist_engine ring decode
    ii, jj = np.maximum(ii, jj), np.minimum(ii, jj)
    keep = (ii < n_total) & (jj < n_total)
    return ii[keep], jj[keep]


# ---------------------------------------------------------------------------
# The engines over the ring (host code as in the JAX module)

# Source: rabbittclust_tpu/parallel/multihost.py::multihost_threshold_clusters
def multihost_threshold_clusters(
        local_hashes: List[np.ndarray], n_total: int, threshold: float,
        kmer_size: int, is_containment: bool = False, bits: int = 8192,
        mesh: Optional[GlobalMesh] = None) -> List[List[int]]:
    """Exact single-linkage partition at ``threshold`` across processes.

    Every process returns the identical full partition (BFS-ordered from
    the merged forest).  Pipeline: global bitmap ring -> per-process gated
    native exact verify of its own candidates -> allgather of the verified
    edge forests -> deterministic Kruskal + BFS on every process."""
    from ..cluster.mst import clusters_from_forest, kruskal
    from ..cluster.union_find import UnionFind
    from ..ops.cluster_fast import _gated_verify_block

    use64 = _local_use64(local_hashes)
    ii, jj = multihost_candidate_pairs_bitmap(
        local_hashes, n_total, threshold, kmer_size,
        is_containment=is_containment, bits=bits, mesh=mesh)
    all_hashes = allgather_sketches(local_hashes, use64)
    assert len(all_hashes) == n_total, (len(all_hashes), n_total)
    sizes = np.array([len(h) for h in all_hashes], dtype=np.int64)
    uf = UnionFind(n_total)
    csr = bm.CsrSketches(all_hashes)
    ki: List[int] = []
    kj: List[int] = []
    kd: List[float] = []
    _gated_verify_block(uf, csr, sizes, ii, jj, threshold, kmer_size,
                        is_containment, ki, kj, kd)
    gi = np.concatenate(_allgather_ragged(np.asarray(ki, dtype=np.int64)))
    gj = np.concatenate(_allgather_ragged(np.asarray(kj, dtype=np.int64)))
    gd = np.concatenate(_allgather_ragged(np.asarray(kd, dtype=np.float64)))
    forest = kruskal((gi, gj, gd), n_total)
    return clusters_from_forest(forest, n_total)


# Source: rabbittclust_tpu/parallel/multihost.py::multihost_mst
def multihost_mst(local_hashes: List[np.ndarray], n_total: int,
                  threshold: float, kmer_size: int,
                  is_containment: bool = False, bits: int = 8192,
                  mesh: Optional[GlobalMesh] = None):
    """Distributed MST across processes via the bitmap ring: exact for
    every cut <= threshold (see dist_engine.distributed_mst
    engine="bitmap").  Every process returns the identical MstResult."""
    from ..cluster.mst import MstResult, kruskal

    use64 = _local_use64(local_hashes)
    ii, jj = multihost_candidate_pairs_bitmap(
        local_hashes, n_total, threshold, kmer_size,
        is_containment=is_containment, bits=bits, mesh=mesh)
    all_hashes = allgather_sketches(local_hashes, use64)
    sizes = np.array([len(h) for h in all_hashes], dtype=np.int64)
    common = bm.CsrSketches(all_hashes).count_common(ii, jj).astype(np.int64)
    nz = common > 0
    ii, jj, common = ii[nz], jj[nz], common[nz]
    if is_containment:
        d = aaf_distance(common, sizes[ii], sizes[jj], kmer_size)
    else:
        d = mash_distance(common, sizes[ii], sizes[jj], kmer_size)
    # per-process partial MST (<= N-1 edges) -> allgather -> global Kruskal
    part = kruskal((ii, jj, d), n_total)
    gi = np.concatenate(_allgather_ragged(part[0]))
    gj = np.concatenate(_allgather_ragged(part[1]))
    gd = np.concatenate(_allgather_ragged(part[2]))
    return MstResult(mst=kruskal((gi, gj, gd), n_total), n=n_total)


# Source: rabbittclust_tpu/parallel/multihost.py::multihost_similarity_graph
def multihost_similarity_graph(local_hashes: List[np.ndarray], n_total: int,
                               threshold: float, kmer_size: int,
                               bits: int = 8192,
                               mesh: Optional[GlobalMesh] = None):
    """Leiden similarity graph across processes: edge iff dist < threshold
    and size ratio >= 0.5, weight = 1 - dist (leiden.cpp:188-256
    semantics) — the edge set and float64 weights of
    cluster.leiden.build_similarity_graph on every process."""
    use64 = _local_use64(local_hashes)
    radio_safe = max(2, int(math.ceil(2.0 * math.exp(
        threshold * kmer_size))) + 1)
    ii, jj = multihost_candidate_pairs_bitmap(
        local_hashes, n_total, threshold, kmer_size, bits=bits,
        radio=radio_safe, mesh=mesh)
    all_hashes = allgather_sketches(local_hashes, use64)
    sizes = np.array([len(h) for h in all_hashes], dtype=np.int64)
    common = bm.CsrSketches(all_hashes).count_common(ii, jj).astype(np.int64)
    nz = common > 0
    ii, jj, common = ii[nz], jj[nz], common[nz]
    s0, s1 = sizes[ii], sizes[jj]
    ratio = np.minimum(s0, s1) / np.maximum(np.maximum(s0, s1), 1)
    d = np.clip(mash_distance(common, s0, s1, kmer_size), 0.0, 1.0)
    ok = (ratio >= 0.5) & (d < threshold)
    frm = np.minimum(ii[ok], jj[ok])
    to = np.maximum(ii[ok], jj[ok])
    ww = 1.0 - d[ok]
    # allgather per-process edges; canonical (frm, to) sort -> identical
    # graph arrays on every process regardless of ring decode order
    gf = np.concatenate(_allgather_ragged(frm))
    gt = np.concatenate(_allgather_ragged(to))
    gw = np.concatenate(_allgather_ragged(ww))
    order = np.lexsort((gt, gf))
    return gf[order], gt[order], gw[order], all_hashes


# Source: rabbittclust_tpu/parallel/multihost.py::multihost_leiden
def multihost_leiden(local_hashes: List[np.ndarray], n_total: int,
                     threshold: float, kmer_size: int,
                     resolution: float = 1.0, use_leiden: bool = True,
                     knn_k: int = 0, bits: int = 8192,
                     mesh: Optional[GlobalMesh] = None,
                     edge_parallel: bool = False) -> List[List[int]]:
    """Distributed clust-leiden: graph build sharded across processes,
    then the deterministic Louvain/Leiden runs on every process over the
    identical merged graph — the partition of the single-host
    cluster.leiden.community_clusters."""
    from ..cluster.leiden import _knn_prune, cluster_graph

    frm, to, ww, _ = multihost_similarity_graph(
        local_hashes, n_total, threshold, kmer_size, bits=bits, mesh=mesh)
    graph = _knn_prune(frm, to, ww, knn_k)
    return cluster_graph(n_total, graph, resolution, use_leiden,
                         edge_parallel=edge_parallel)


# Source: rabbittclust_tpu/parallel/multihost.py::multihost_greedy
def multihost_greedy(local_hashes: List[np.ndarray], n_total: int,
                     threshold: float, kmer_size: int,
                     is_containment: bool = False, batch: int = 2048,
                     mesh: Optional[GlobalMesh] = None):
    """Distributed greedy clustering with EXACT serial semantics.

    Returns (clusters_in_sorted_space, order) — identical on every process
    and equal to greedy_cluster(sorted_hashes, presorted=True) on the kssd
    greedy order (reference KssdGreedyClusterWithInvertedIndex,
    greedy.cpp:566-899).  The scoring of each batch against the
    representatives' inverted index is sharded across processes; the
    serial commit is replayed identically on every process, and a genome
    whose batch created an earlier new rep that could beat-or-tie its
    pre-scored best is re-probed against the live index."""
    from ..cluster.greedy import RepInvertedIndex
    from ..sketch.base import stdsort_size_desc

    if mesh is None:
        mesh = global_mesh()
    use64 = _local_use64(local_hashes)
    all_hashes = allgather_sketches(local_hashes, use64)
    sizes0 = np.array([len(h) for h in all_hashes], dtype=np.int64)
    order = stdsort_size_desc(sizes0)
    inv = [all_hashes[i] for i in order]
    sizes = sizes0[order]
    n = n_total
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    n_proc, pid = mesh.world, mesh.rank

    index = RepInvertedIndex()
    representatives = [0]
    rep2cid = {0: 0}
    members: List[List[int]] = [[]]
    if n:
        index.add_representative(0, inv[0])

    def pair_sim(g: int, r: int) -> float:
        """Similarity of (g, r) under the greedy bound filter; -1 = no
        candidate (the sizes alone bound |A∩B| <= min(|A|, |B|))."""
        sg, sr = int(sizes[g]), int(sizes[r])
        mn = min(sg, sr)
        if is_containment:
            bound = math.ceil(c_min * mn)
        else:
            bound = math.ceil(j_min * (sg + sr) / (1.0 + j_min))
        if mn < bound:
            return -1.0
        common = len(np.intersect1d(inv[g], inv[r], assume_unique=True))
        if common < bound:
            return -1.0
        if is_containment:
            return 1.0 if mn == 0 else common / mn
        denom = sg + sr - common
        return 1.0 if denom == 0 else common / denom

    def score(g: int):
        touched, counts = index.probe(inv[g])
        best_sim, best_rep = -1.0, -1
        sg = int(sizes[g])
        for rep_id, common in zip(touched, counts):
            sr = int(sizes[rep_id])
            if is_containment:
                mn = min(sg, sr)
                if common < math.ceil(c_min * mn):
                    continue
                sim = 1.0 if mn == 0 else common / mn
            else:
                common_min = math.ceil(j_min * (sg + sr) / (1.0 + j_min))
                if common < common_min:
                    continue
                denom = sg + sr - common
                sim = 1.0 if denom == 0 else common / denom
            if sim > best_sim:  # strict: first-touch wins ties
                best_sim = sim
                best_rep = rep_id
        return best_sim, best_rep

    b0 = 1
    while b0 < n:
        b1 = min(b0 + batch, n)
        gs = np.arange(b0, b1, dtype=np.int64)
        lo, hi = shard_bounds(len(gs), n_proc, pid)
        my_sim = np.empty(hi - lo, dtype=np.float64)
        my_rep = np.empty(hi - lo, dtype=np.int64)
        for t, g in enumerate(gs[lo:hi].tolist()):
            my_sim[t], my_rep[t] = score(g)
        sims = np.concatenate(_allgather_ragged(my_sim))
        reps_pre = np.concatenate(_allgather_ragged(my_rep))
        new_reps: List[int] = []
        for t, g in enumerate(gs.tolist()):
            best_sim, best_rep = float(sims[t]), int(reps_pre[t])
            # conflict: an intra-batch new rep is a CANDIDATE (passes the
            # bound) and beats-or-ties the pre-scored best — only then can
            # the serial outcome differ, so re-probe against the live index
            if any(s >= 0.0 and s >= best_sim
                   for s in (pair_sim(g, r) for r in new_reps)):
                best_sim, best_rep = score(g)  # exact serial re-probe
            if best_rep != -1:
                members[rep2cid[best_rep]].append(g)
            else:
                rep2cid[g] = len(representatives)
                representatives.append(g)
                members.append([])
                index.add_representative(g, inv[g])
                new_reps.append(g)
        b0 = b1
    clusters = [[rep] + mem for rep, mem in zip(representatives, members)]
    return clusters, order


# Source: rabbittclust_tpu/parallel/multihost.py::multihost_dbscan
def multihost_dbscan(local_hashes: List[np.ndarray], n_total: int,
                     eps: float, min_pts: int, kmer_size: int,
                     knn_k: int = 0, max_posting: int = 0,
                     minhash: bool = False, is_containment: bool = False,
                     bits: int = 8192, mesh: Optional[GlobalMesh] = None):
    """Distributed clust-dbscan across processes (KSSD or MinHash
    semantics): the global bitmap ring at threshold=eps (a superset of the
    neighbour criterion under the widened ``radio``; ``radio`` 0, no ratio
    gate, for MinHash containment) -> each process exact-verifies ITS
    candidates against the allgathered sketch store -> edge allgather ->
    identical serial expansion on every process (expand_labels).  Mirrors
    dbscan_cluster / minhash_dbscan_cluster (reference dbscan.cpp:559-565,
    831-870, 987-1097), kNN ties broken by neighbour id as there."""
    from ..cluster.dbscan import (expand_labels, result_from_labels,
                                  trim_postings)

    if minhash and (knn_k or max_posting):
        raise ValueError("knn_k/max_posting are KSSD-engine accelerators; "
                         "the MinHash DBSCAN engine has neither "
                         "(dbscan.cpp:987-1097)")
    if is_containment and not minhash:
        raise ValueError("is_containment applies to the MinHash DBSCAN "
                         "criterion only (KSSD dbscan has no containment "
                         "mode, dbscan.cpp:559-565)")
    if mesh is None:
        mesh = global_mesh()
    n_proc, pid = mesh.world, mesh.rank
    use64 = _local_use64(local_hashes)
    all_hashes = allgather_sketches(local_hashes, use64)
    # criterion sizes are the ORIGINAL sketch sizes even under truncation
    sizes = np.array([len(h) for h in all_hashes], dtype=np.int64)
    if knn_k > 0 and knn_k < min_pts - 1:
        knn_k = min_pts - 1  # dbscan_cluster's adjustment, warning elided
    if max_posting > 0:
        all_hashes = trim_postings(all_hashes, max_posting)
        lo, hi = shard_bounds(n_total, n_proc, pid)
        local_hashes = all_hashes[lo:hi]
    x = math.exp(-eps * kmer_size)
    t = x / (2.0 - x)  # jaccard_min
    if minhash and eps >= 1.0:
        # dist caps at 1.0 <= eps: everything neighbors everything,
        # including common == 0 pairs the ring never yields
        full = np.arange(n_total, dtype=np.int64)
        adj = [np.delete(full, i) for i in range(n_total)]
        labels, k = expand_labels(adj, n_total, min_pts, include_self=False)
        return result_from_labels(labels, n_total, k, drop_empty=True)
    # containment jaccard is size-ratio-free: radio=0 disables the ring's
    # ratio gate; otherwise widen the ring's ratio prefilter to the
    # criterion's bound
    radio = 0 if (minhash and is_containment) else max(
        2, int(math.ceil(2.0 / x))) + 1
    ii, jj = multihost_candidate_pairs_bitmap(
        local_hashes, n_total, eps, kmer_size,
        is_containment=minhash and is_containment, bits=bits, radio=radio,
        mesh=mesh)
    common = bm.CsrSketches(all_hashes).count_common(ii, jj).astype(np.int64)
    nz = common > 0  # both engines enumerate index pairs (common >= 1) only
    ii, jj, common = ii[nz], jj[nz], common[nz]
    s0 = sizes[ii].astype(np.float64)
    s1 = sizes[jj].astype(np.float64)
    cc = common.astype(np.float64)
    if minhash:
        if is_containment:
            denom = np.minimum(sizes[ii], sizes[jj]).astype(np.float64)
        else:
            denom = s0 + s1 - cc
        jac = np.where(denom > 0, cc / np.maximum(denom, 1.0), 0.0)
        with np.errstate(divide="ignore"):
            if is_containment:
                dist_ = -np.log(jac) / kmer_size
            else:
                dist_ = -np.log(2.0 * jac / (1.0 + jac)) / kmer_size
        dist_ = np.minimum(dist_, 1.0)
        dist_ = np.where(jac >= 1.0, 0.0, np.where(jac <= 0.0, 1.0, dist_))
        ok = dist_ <= eps
    else:
        ok = (cc * (1.0 + t) + 1e-12 >= t * (s0 + s1)) \
            & (sizes[ii] > 0) & (sizes[jj] > 0)
    denomj = s0 + s1 - cc
    jacv = np.where(denomj > 0, cc / np.maximum(denomj, 1.0), 0.0)
    a = np.minimum(ii[ok], jj[ok])
    b = np.maximum(ii[ok], jj[ok])
    jv = jacv[ok]
    ga = np.concatenate(_allgather_ragged(a))
    gb = np.concatenate(_allgather_ragged(b))
    gj = np.concatenate(_allgather_ragged(jv))
    # canonical lexsort + dedupe -> identical edge arrays on every process
    order = np.lexsort((gb, ga))
    ga, gb, gj = ga[order], gb[order], gj[order]
    if len(ga):
        keep = np.r_[True, (ga[1:] != ga[:-1]) | (gb[1:] != gb[:-1])]
        ga, gb, gj = ga[keep], gb[keep], gj[keep]
    # adjacency (both directions), neighbor-id ascending per node
    src = np.concatenate([ga, gb])
    dst = np.concatenate([gb, ga])
    wts = np.concatenate([gj, gj])
    order2 = np.lexsort((dst, src))
    src, dst, wts = src[order2], dst[order2], wts[order2]
    bounds = np.searchsorted(src, np.arange(n_total + 1))
    adj = [dst[bounds[i]:bounds[i + 1]] for i in range(n_total)]
    if knn_k > 0:
        for i in range(n_total):
            if len(adj[i]) > knn_k:
                w = wts[bounds[i]:bounds[i + 1]]
                idx = np.argsort(-w, kind="stable")[:knn_k]
                adj[i] = adj[i][idx]
    labels, k = expand_labels(adj, n_total, min_pts,
                              include_self=not minhash)
    return result_from_labels(labels, n_total, k, drop_empty=minhash)


# Source: rabbittclust_tpu/parallel/multihost.py::multihost_repdb_query
def multihost_repdb_query(state, local_query_hashes: List[np.ndarray],
                          topk: int) -> List[List[dict]]:
    """Sharded RepDB probe (distributed serving of --db --query).

    Every process holds a replica of the RepDB state (loaded from the same
    file — the reference serving model, sub_command.cpp query verb) and
    probes ONLY its contiguous query shard; per-query hit rows
    (rep_idx, distance) are allgathered and every host reconstructs the
    full ordered hit lists from its replica — identical to the serial
    ``[state.query_topk(q, topk) for q in queries]`` over the concatenated
    query shards.  Works for both KssdClusterState and MinHashClusterState
    (same query_topk contract)."""
    counts: List[int] = []
    reps: List[int] = []
    dists: List[float] = []
    for q in local_query_hashes:
        hits = state.query_topk(q, topk)
        counts.append(len(hits))
        for h in hits:
            reps.append(h["rep_idx"])
            dists.append(h["distance"])
    gc = np.concatenate(_allgather_ragged(
        np.asarray(counts, dtype=np.int64)))
    gr = np.concatenate(_allgather_ragged(np.asarray(reps, dtype=np.int64)))
    gd = np.concatenate(_allgather_ragged(
        np.asarray(dists, dtype=np.float64)))
    out: List[List[dict]] = []
    off = 0
    for c in gc.tolist():
        row = []
        for t in range(c):
            rep_idx = int(gr[off + t])
            gid = state.representative_ids[rep_idx]
            row.append({
                "rep_idx": rep_idx, "genome_id": gid,
                "genome_name": state.file_names[gid],
                "distance": float(gd[off + t]), "cluster_id": rep_idx,
                "cluster_size": len(state.clusters[rep_idx]),
            })
        out.append(row)
        off += c
    return out


# Source: rabbittclust_tpu/parallel/multihost.py::multihost_repdb_assign
def multihost_repdb_assign(state,
                           local_query_hashes: List[np.ndarray]
                           ) -> List[dict]:
    """Sharded RepDB assignment: top-1 probe + the threshold acceptance of
    ``state.assign`` replayed on the gathered hits (identical to the
    serial assign loop over the concatenated query shards)."""
    res = multihost_repdb_query(state, local_query_hashes, 1)
    out = []
    for hits in res:
        if hits and hits[0]["distance"] <= state.threshold:
            out.append(hits[0])
        else:
            out.append({"rep_idx": -1, "genome_id": -1,
                        "genome_name": "unassigned", "distance": -1.0,
                        "cluster_id": -1, "cluster_size": 0})
    return out


# ---------------------------------------------------------------------------
# Local simulation: N processes on one machine running the self-test

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# torch threads of a simulated process, so that several simulations side by
# side do not oversubscribe the host
SIM_THREADS = 2


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class RanksTimedOut(RuntimeError):
    """``run_ranks`` outlived its timeout: every rank was killed and
    reaped (``returncodes``; ``stderr`` is what each wrote)."""

    def __init__(self, timeout: float, returncodes: List[int],
                 stderr: List[str]):
        super().__init__(f"the ranks timed out after {timeout} s")
        self.returncodes = returncodes
        self.stderr = stderr


def run_ranks(cmds: Sequence[Sequence[str]], env: Optional[dict] = None,
              timeout: float = 600.0, cwd: Optional[str] = None
              ) -> Tuple[List[int], List[str], List[str]]:
    """Run one process per command of ``cmds`` side by side until every one
    has ended or ``timeout`` seconds have passed; then kill any still
    running and reap them all.  Output goes to files, not pipes: a rank
    blocked on a full pipe would stall the others at their next
    collective.  Returns each rank's return code, stdout and stderr;
    raises ``RanksTimedOut`` at the timeout."""
    files = [(tempfile.TemporaryFile(mode="w+"),
              tempfile.TemporaryFile(mode="w+")) for _ in cmds]
    procs: List[subprocess.Popen] = []
    timed_out = False
    try:
        for cmd, (out, err) in zip(cmds, files):
            procs.append(subprocess.Popen(list(cmd), stdout=out, stderr=err,
                                          text=True, env=env, cwd=cwd))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        texts = []
        for pair in files:
            for f in pair:
                f.seek(0)
                texts.append(f.read())
                f.close()
    rcs = [p.returncode for p in procs]
    if timed_out:
        raise RanksTimedOut(timeout, rcs, texts[1::2])
    return rcs, texts[0::2], texts[1::2]


# Source: rabbittclust_tpu/parallel/multihost.py::launch_local_sim
def launch_local_sim(num_processes: int = 2, devices_per_proc: int = 4,
                     n_genomes: int = 48, port: int = 0,
                     timeout: float = 420.0, device: str = "cuda",
                     out_dir: Optional[str] = None) -> List[str]:
    """Spawn ``num_processes`` local processes with ``devices_per_proc``
    shards each running the multihost self-test (``_sim_child``): each on
    its card (``device="cuda"``: ``cuda:(pid % device_count)`` repeated
    ``devices_per_proc`` times; a child that finds no GPU raises), or on
    CPU shards when asked (``device="cpu"``, through
    ``RTC_VIRTUAL_CPU_DEVICES``).  With ``out_dir`` each child writes its
    results to ``out_dir/proc<pid>.pkl``.  Returns each child's last stdout
    line; a child that fails raises, and on ``timeout`` every child is
    killed."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device is cpu or cuda, got {device!r}")
    if port == 0:
        port = free_port()
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = str(SIM_THREADS)
    if device == "cpu":
        env["RTC_VIRTUAL_CPU_DEVICES"] = str(devices_per_proc)
    else:
        env.pop("RTC_VIRTUAL_CPU_DEVICES", None)
    cmds = [[sys.executable, "-m", "rabbittclust_tpu_torch.parallel.multihost",
             str(pid), str(num_processes), str(port), str(devices_per_proc),
             str(n_genomes), out_dir or ""]
            for pid in range(num_processes)]
    try:
        rcs, outs, errs = run_ranks(cmds, env=env, timeout=timeout,
                                    cwd=_REPO)
    except RanksTimedOut as exc:
        raise RuntimeError(f"multihost sim timed out after {timeout} s"
                           ) from exc
    for rc, err in zip(rcs, errs):
        if rc != 0:
            raise RuntimeError(f"multihost sim child failed (rc={rc}):\n"
                               f"{err[-4000:]}")
    return [o.strip().splitlines()[-1] if o.strip() else "" for o in outs]


# Source: rabbittclust_tpu/parallel/multihost.py::_make_sim_sketches
def _make_sim_sketches(n: int, seed: int = 3) -> List[np.ndarray]:
    """Deterministic clustered synthetic sketches (same on every process)."""
    rng = np.random.default_rng(seed)
    bases = [np.unique(rng.integers(0, 2 ** 28, size=120).astype(np.uint32))
             for _ in range(max(n // 8, 1))]
    out = []
    for i in range(n):
        b = bases[i % len(bases)]
        keep = b[rng.random(len(b)) < 0.8]
        extra = np.unique(
            rng.integers(0, 2 ** 28, size=130 - len(keep)).astype(np.uint32))
        out.append(np.unique(np.concatenate([keep, extra])))
    return out


# Source: rabbittclust_tpu/parallel/multihost.py::_make_sim_sketches_sized
def _make_sim_sketches_sized(n: int, seed: int = 3) -> List[np.ndarray]:
    """Clustered synthetic sketches with per-genome size variation —
    distinct jaccard values at every kNN cut (no ties)."""
    rng = np.random.default_rng(seed)
    bases = [np.unique(rng.integers(0, 2 ** 28,
                                    size=120 + 11 * b).astype(np.uint32))
             for b in range(max(n // 8, 1))]
    out = []
    for i in range(n):
        b = bases[i % len(bases)]
        keep = b[rng.random(len(b)) < 0.8]
        extra = np.unique(rng.integers(
            0, 2 ** 28,
            size=max(8, 140 + 7 * (i % 13) - len(keep))).astype(np.uint32))
        out.append(np.unique(np.concatenate([keep, extra])))
    return out


# Source: rabbittclust_tpu/parallel/multihost.py::_make_sim_sketches_spread
def _make_sim_sketches_spread(n: int, seed: int = 11) -> List[np.ndarray]:
    """Subset-containment corpus with a >5x sketch-size spread: each group
    is one 300-hash 'big' genome plus two 40-hash random SUBSETS of it
    (containment jaccard 1.0, size ratio 7.5), which the MST size-ratio
    gate would drop."""
    rng = np.random.default_rng(seed)
    out = []
    big = None
    for i in range(n):
        if i % 3 == 0 or big is None:
            big = np.unique(
                rng.integers(0, 2 ** 28, size=300).astype(np.uint32))
            out.append(big)
        else:
            out.append(np.sort(rng.choice(big, size=40, replace=False)))
    return out


def _dbscan_record(res) -> dict:
    return {"labels": res.labels.tolist(),
            "clusters": [[int(x) for x in c] for c in res.clusters],
            "noise": [int(x) for x in res.noise]}


# Source: rabbittclust_tpu/parallel/multihost.py::_sim_child
def _sim_child(process_id: int, num_processes: int, port: int,
               devices_per_proc: int, n_genomes: int,
               out_dir: str = "") -> None:
    torch.set_num_threads(SIM_THREADS)
    mesh = init_multihost(f"127.0.0.1:{port}", num_processes, process_id,
                          local_devices(process_id, devices_per_proc))
    from ..cluster.dbscan import dbscan_cluster, minhash_dbscan_cluster
    from ..cluster.greedy import greedy_cluster
    from ..cluster.leiden import build_similarity_graph, community_clusters
    from ..cluster.mst import clusters_from_forest, compute_mst, cut_forest
    from ..sketch.base import stdsort_size_desc

    assert mesh.world == num_processes
    assert mesh.size == num_processes * devices_per_proc
    hashes = _make_sim_sketches(n_genomes)
    lo, hi = shard_bounds(n_genomes, num_processes, process_id)
    clusters = multihost_threshold_clusters(
        hashes[lo:hi], n_genomes, 0.05, 21, bits=2048)
    # single-host reference partition, computed locally from the full set
    res = compute_mst(hashes, 0.05, 21)
    expect = clusters_from_forest(cut_forest(res.mst, 0.05), n_genomes)
    canon = sorted(tuple(sorted(c)) for c in clusters)
    canon_h = sorted(tuple(sorted(c)) for c in expect)
    assert canon == canon_h, "multihost partition != single-host partition"
    # bitmap-ring MST cut must be byte-equal to the host MST cut
    res_mh = multihost_mst(hashes[lo:hi], n_genomes, 0.05, 21, bits=2048)
    cb = cut_forest(res_mh.mst, 0.05)
    chost = cut_forest(res.mst, 0.05)
    for a, b in zip(cb, chost):
        assert a.tolist() == b.tolist(), "multihost MST cut != host cut"
    cl_mh = multihost_leiden(hashes[lo:hi], n_genomes, 0.05, 21, bits=2048)
    cl_host = community_clusters(hashes, 0.05, 21)
    assert cl_mh == cl_host, "multihost leiden != single-host leiden"
    gf, gt, gw, _ = multihost_similarity_graph(hashes[lo:hi], n_genomes,
                                               0.05, 21, bits=2048)
    hf, ht, hw = build_similarity_graph(hashes, 0.05, 21)
    assert sorted(zip(gf.tolist(), gt.tolist(), gw.tolist())) == \
        sorted(zip(hf.tolist(), ht.tolist(), hw.tolist())), \
        "multihost similarity graph != host graph"
    g_mh, g_order = multihost_greedy(hashes[lo:hi], n_genomes, 0.05, 21,
                                     batch=13)
    order = stdsort_size_desc(
        np.array([len(h) for h in hashes], dtype=np.int64))
    assert g_order.tolist() == order.tolist()
    g_host = greedy_cluster([hashes[i] for i in order], 0.05, 21,
                            presorted=True)
    assert g_mh == g_host.clusters, "multihost greedy != serial greedy"
    gc_mh, _ = multihost_greedy(hashes[lo:hi], n_genomes, 0.05, 21,
                                is_containment=True, batch=13)
    gc_host = greedy_cluster([hashes[i] for i in order], 0.05, 21,
                             presorted=True, is_containment=True)
    assert gc_mh == gc_host.clusters, \
        "multihost containment greedy != serial containment greedy"
    db_mh = multihost_dbscan(hashes[lo:hi], n_genomes, 0.05, 3, 21,
                             bits=2048)
    db_host = dbscan_cluster(hashes, 0.05, 3, 21)
    assert db_mh.labels.tolist() == db_host.labels.tolist(), \
        "multihost dbscan labels != single-host labels"
    assert db_mh.clusters == db_host.clusters
    assert db_mh.noise == db_host.noise
    dbp_mh = multihost_dbscan(hashes[lo:hi], n_genomes, 0.05, 3, 21,
                              max_posting=32, bits=2048)
    dbp_host = dbscan_cluster(hashes, 0.05, 3, 21, max_posting=32)
    assert dbp_mh.labels.tolist() == dbp_host.labels.tolist(), \
        "multihost dbscan (max_posting) != single-host"
    # knn-capped comparison on the tie-free sized corpus
    sized = _make_sim_sketches_sized(n_genomes)
    dbk_mh = multihost_dbscan(sized[lo:hi], n_genomes, 0.05, 3, 21,
                              knn_k=4, bits=2048)
    dbk_host = dbscan_cluster(sized, 0.05, 3, 21, knn_k=4)
    assert dbk_mh.labels.tolist() == dbk_host.labels.tolist(), \
        "multihost dbscan (knn) != single-host"
    dbm_mh = multihost_dbscan(hashes[lo:hi], n_genomes, 0.05, 3, 21,
                              minhash=True, bits=2048)
    dbm_host = minhash_dbscan_cluster(hashes, 0.05, 3, 21)
    assert dbm_mh.labels.tolist() == dbm_host.labels.tolist(), \
        "multihost minhash dbscan != single-host"
    assert dbm_mh.clusters == dbm_host.clusters
    dbc_mh = multihost_dbscan(hashes[lo:hi], n_genomes, 0.05, 3, 21,
                              minhash=True, is_containment=True, bits=2048)
    dbc_host = minhash_dbscan_cluster(hashes, 0.05, 3, 21,
                                      is_containment=True)
    assert dbc_mh.labels.tolist() == dbc_host.labels.tolist(), \
        "multihost containment minhash dbscan != single-host"
    # containment with a 7.5x sketch-size spread: the ring must NOT apply
    # the MST size-ratio gate (radio=0 mode) or every big-subset pair drops
    sp = _make_sim_sketches_spread(n_genomes)
    dbs_mh = multihost_dbscan(sp[lo:hi], n_genomes, 0.05, 2, 21,
                              minhash=True, is_containment=True, bits=2048)
    dbs_host = minhash_dbscan_cluster(sp, 0.05, 2, 21, is_containment=True)
    assert any(len(c) >= 3 for c in dbs_host.clusters), \
        "spread corpus failed to form big+subset clusters (bad fixture)"
    assert dbs_mh.labels.tolist() == dbs_host.labels.tolist(), \
        "multihost containment dbscan (size spread) != single-host"
    # multihost RepDB probe/assign == the serial query loop over the same
    # replica (sharded serving; every process loads the identical state)
    from ..sketch.base import SketchSet
    from ..sketch.kssd import KssdParams
    from ..state.greedy_state import KssdClusterState
    p_db = KssdParams.from_kmer_size(21, 3)
    ss_db = SketchSet("kssd", p_db, True, False)
    for i, h in enumerate(hashes):
        ss_db.append_genome(file_name=f"g{i}.fna", name=f"g{i}", comment="",
                            seq0_len=1000, total_len=1000, num_seqs=1,
                            hashes=h)
    ss_db2 = ss_db.reorder(ss_db.kssd_greedy_order())
    st = KssdClusterState.from_clustering(
        ss_db2, p_db, greedy_cluster(ss_db2.hashes, 0.05, 21,
                                     presorted=True), 0.05)
    queries = _make_sim_sketches(n_genomes, seed=7)
    qlo, qhi = shard_bounds(len(queries), num_processes, process_id)
    q_mh = multihost_repdb_query(st, queries[qlo:qhi], 3)
    q_host = [st.query_topk(q, 3) for q in queries]
    assert q_mh == q_host, "multihost repdb query != serial query loop"
    a_mh = multihost_repdb_assign(st, queries[qlo:qhi])
    a_host = [st.assign(q) for q in queries]
    assert a_mh == a_host, "multihost repdb assign != serial assign loop"
    g_mh = [[int(x) for x in c] for c in g_mh]
    cl_mh = [[int(x) for x in c] for c in cl_mh]
    digest = hashlib.sha256(repr(
        (canon, cl_mh, g_mh, db_mh.labels.tolist())).encode()
    ).hexdigest()[:16]
    if out_dir:
        result = {
            "partition": [[int(x) for x in c] for c in clusters],
            "mst_cut": [a.tolist() for a in cb], "leiden": cl_mh,
            "graph": (gf.tolist(), gt.tolist(), gw.tolist()),
            "greedy": g_mh, "greedy_order": g_order.tolist(),
            "greedy_containment": [[int(x) for x in c] for c in gc_mh],
            "dbscan": {name: _dbscan_record(r) for name, r in (
                ("plain", db_mh), ("max_posting", dbp_mh), ("knn", dbk_mh),
                ("minhash", dbm_mh), ("containment", dbc_mh),
                ("spread", dbs_mh))},
            "repdb_query": q_mh, "repdb_assign": a_mh,
            "ring": dict(RING_LAST), "digest": digest}
        with open(os.path.join(out_dir, f"proc{process_id}.pkl"), "wb") as f:
            pickle.dump(result, f)
    print(f"OK proc={process_id}/{num_processes} devices={mesh.size} "
          f"transport={mesh.transport} clusters={len(clusters)} "
          f"leiden={len(cl_mh)} greedy={len(g_mh)} "
          f"dbscan={len(db_mh.clusters)} ring_launches="
          f"{de.LAUNCHES['ring_bitmap']} digest={digest}", flush=True)
    shutdown_multihost()


if __name__ == "__main__":
    _sim_child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               int(sys.argv[4]), int(sys.argv[5]),
               sys.argv[6] if len(sys.argv) > 6 else "")
