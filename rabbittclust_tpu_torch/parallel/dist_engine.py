"""Mesh ring engines over a list of devices (counterpart of
``rabbittclust_tpu/parallel/dist_engine.py``).

The JAX module is one controller driving a ``Mesh`` under ``shard_map``:
genomes are sharded row-block over the devices, and at ring step t every
device compares its resident rows against the visiting column shard, then
``ppermute`` passes the visiting shard to its ring neighbour.  Here one
process holds a list of ``torch.device`` (``make_mesh``); each shard's rows
stay on their device, and the ``ppermute`` is a copy of the visiting shard
to the next shard's device (the same tensors when the list repeats a
device, so ``[cuda:0] * 4`` runs every step of a 4-shard ring on one card,
one shard after another).  ``pmin`` and ``psum`` are a minimum and a sum
over the shards' partial results on the first device.

The triangular schedule (``_n_ring_steps``, ``_ownership_mask``) covers
every unordered pair once.  For the kernels it reduces to three tile kinds
(``_step_kind``): the self step keeps the strict lower triangle, the
antipodal step of an even ring the whole tile on the higher shard and
nothing on the lower, every other step the whole tile; the plain versions
apply the JAX mask to the genome ids instead.

Programs, each a wrapper that launches hand-written kernels on the card
and runs its plain torch version on CPU tensors:

* ``ring_stats_step`` (``build_ring_fn``, the stats ring of
  ``distributed_candidate_stats``): K4's stats mode over (local shard,
  visiting shard), plane 0: the float32 Mash distance of every gated pair,
  reduced on the card to a count at the threshold and a minimum;
* ``ring_edges_step`` (``build_ring_edges_fn``, exact ring): K4's mask
  mode over (local shard, visiting shard), K3 to compact, K5b for the
  exact common counts of the survivors;
* ``ring_masks_step`` (``build_ring_masks_fn``, and the step of
  ``build_ring_bitmap_fn``): the ring step's kernel (``csrc/ring_step.cu``)
  over the two shards' signatures into the shard's resident mask slab, its
  count into the slab's counts on the device; the self step visits only
  its lower-triangle tiles;
* ``ring_positions`` (the rest of ``build_ring_bitmap_fn``): after the
  ring, one K3 launch over a shard's slab from its counts on the card
  (counted as ``ops/bitmap.py``'s), one pull of the counts, one of its
  candidates' positions into a pinned host buffer;
* ``dist_lp_round`` (``dist_lp_round_fn``): K2 over each shard's slab,
  then the minimum and sum over the shards.

Shard geometry is the JAX module's (rows padded to a multiple of the shard
count, or of 128 shards for the LP slabs), so the candidate lists come out
in its order.  On the card each shard's buffers carry extra zero-size rows
up to a multiple of 128 (K4 reads groups of 128 genomes); those rows never
pass a gate and are dropped before any output.

``_ring`` is the one ring driver, ``ring_slabs`` the bitmap and mask
rings' sweep over it (nothing goes to the host between its first step and
its last); ``parallel/multihost.py`` runs it over a mesh of processes by
giving it a shift that hands the last local shard to the next process.

Spans and counters (``utils/profiling.py``): every ring opens ``mesh.ring``
and a ``mesh.hop`` a shift, and counts ``mesh.steps`` (its (shard, step)
pairs, the empty antipodal ones too) and, under the default shift,
``mesh.hop_bytes`` (what the copies move between distinct devices).
``distributed_mst`` counts ``mesh.cards``; over the exact ring it opens
``mesh.pack``, ``mesh.upload``, ``mesh.step_wait`` a step (on the card K3's
enqueue and the pull of its total, the step's one sync), ``mesh.decode``
and ``mesh.kruskal``, and counts ``mesh.candidates`` (the edges ``kruskal``
is given) and, on the card, ``mesh.card_peak_bytes`` (the largest
``max_memory_allocated`` over the mesh's devices).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, fields, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cluster.mst import (MstResult, clusters_from_forest, cut_forest,
                           kruskal, sort_edges)
from ..cluster.union_find import UnionFind
from ..device import resolve_device
from ..distance.mash import (aaf_distance, mash_distance,
                             min_jaccard_for_threshold, size_ratio_limit)
from ..ops import bitmap as bm
from ..ops.cluster_fast import _gated_verify_block, gated_verify_merge
from ..ops.intersect import (_upload, pair_common_launch, pair_counts_plain,
                             pair_mask_tiles, pair_stats_tiles,
                             stats_epilogue)
from ..ops.labelprop import MAX_RB, SENT, _clear_quantum, lp_round
from ..ops.pack import (GROUP, _to_device, compact_of, keep_compact,
                        pack_sketches)
from ..ops.transfer import _host_async, _host_wait
from ..utils.profiling import count, span

# the ring step's launches of the bitmap ring count as "ring_bitmap", of the
# mask ring as "ring_masks"; the bitmap ring's closing K3 counts in
# ops/bitmap.py's LAUNCHES["mask_compact"]
LAUNCHES = {"ring_stats": 0, "ring_edges": 0, "ring_bitmap": 0,
            "ring_masks": 0, "dist_lp_round": 0}

# last mesh-lp run's shape facts, for communication accounting; on the card
# also the device milliseconds of the build and of each round
DIST_LP_LAST: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard d lives on ``devices[d]``; a device may repeat."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def cuda(self) -> bool:
        return self.devices[0].type == "cuda"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (by default every visible CUDA device; the
    list may repeat a device), cut to its first ``n_devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh needs a CUDA GPU and "
                               "torch.cuda.is_available() is false; pass "
                               "devices= for another mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh is all CUDA or all CPU: {devs}")
    return Mesh(tuple(devs))


# Source: rabbittclust_tpu/parallel/dist_engine.py::_n_ring_steps
def _n_ring_steps(n_dev: int) -> int:
    """Triangular ring schedule length: floor(n_dev/2) + 1 steps instead of
    n_dev.  At step t every device compares its resident rows against shard
    (d - t) mod n_dev; the unordered shard pair {a, b} with
    (a - b) mod n_dev = t <= n_dev/2 is visited only by device a, so steps
    t in [1, ceil(n_dev/2)) run FULL tiles with no ownership discard.  Only
    the self tile (t=0) and, for even n_dev, the antipodal tile
    (t = n_dev/2, computed by both endpoints) need the global i > j mask."""
    return n_dev // 2 + 1


# Source: rabbittclust_tpu/parallel/dist_engine.py::_ownership_mask
def _ownership_mask(t, n_dev, row_ids, vis_ids):
    """Per-step pair-ownership mask for the triangular schedule (see
    _n_ring_steps): full tile on interior steps, global i > j on the self
    and (even n_dev) antipodal steps."""
    shared_step = (t == 0) or (n_dev % 2 == 0 and t == n_dev // 2)
    own = row_ids[:, None] > vis_ids[None, :]
    return own if shared_step else torch.ones_like(own)


def _step_kind(t: int, n_dev: int, row_lo: int, vis_lo: int) -> str:
    """``_ownership_mask`` as a tile kind: "self" (strict lower triangle),
    "full" or "none" (the antipodal step on the lower shard)."""
    if t == 0:
        return "self"
    if n_dev % 2 == 0 and t == n_dev // 2:
        return "full" if row_lo > vis_lo else "none"
    return "full"


@dataclass
class BitShard:
    """One shard of the bitmap and mask rings: packed signatures (rows,
    bits // 8) uint8, collisions and sizes (rows,) int32; its genomes are
    ``lo``, ``lo + 1``, ... (rows past the logical shard have size 0)."""
    xp: torch.Tensor
    coll: torch.Tensor
    sizes: torch.Tensor
    lo: int

    def to(self, device: torch.device) -> "BitShard":
        return replace(self, xp=self.xp.to(device),
                       coll=self.coll.to(device), sizes=self.sizes.to(device))

    def nbytes(self) -> int:
        return _nbytes(self.xp, self.coll, self.sizes)


@dataclass
class PlaneShard:
    """One shard of the exact ring: packed planes (rows, W, K) int32 (and
    plane1 for 64-bit hashes), sizes (rows,) int32, genomes from ``lo``."""
    p0: torch.Tensor
    p1: Optional[torch.Tensor]
    sizes: torch.Tensor
    lo: int

    def to(self, device: torch.device) -> "PlaneShard":
        """The shard on ``device``.  On another device its compact form
        (K4's and K5b's operand, built once where the shard lives) moves
        with the planes instead of being built again at every step."""
        moved = replace(self, p0=self.p0.to(device),
                        p1=None if self.p1 is None else self.p1.to(device),
                        sizes=self.sizes.to(device))
        if moved.p0 is not self.p0:
            keep_compact(moved.p0, moved.p1,
                         compact_of(self.p0, self.p1).to(device))
        return moved

    def nbytes(self) -> int:
        """Bytes of the planes, the sizes and the compact form: what a
        move to another device copies."""
        form = compact_of(self.p0, self.p1)
        return _nbytes(self.p0, self.p1, self.sizes,
                       *(getattr(form, f.name) for f in fields(form)))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _rows(shard: int, mesh: Mesh, cpu_quantum: int = 1) -> int:
    """Rows of a shard's buffers: the logical shard, padded on the card to
    a multiple of 128 (K4's groups; K1, K2 and K3 take it too), on the CPU
    to a multiple of ``cpu_quantum``."""
    q = GROUP if mesh.cuda else cpu_quantum
    return -(-shard // q) * q


def _ring(mesh: Mesh, shards: list, step, shift=None,
          n_dev: Optional[int] = None) -> list:
    """Run ``step(d, t, local, visiting)`` for every shard d of this
    process and ring step t of a ring of ``n_dev`` shards (the mesh's by
    default); returns out[d][t].  After each step ``shift(visiting)``
    moves every visiting shard one place along the ring (the
    ``ppermute``): by default to the next device of the mesh, so device d
    holds shard (d - t) mod n at step t.  ``parallel/multihost.py`` passes
    a shift that sends the last local shard to the next process.  The
    ring is the span ``mesh.ring``, each shift a ``mesh.hop``; it counts
    ``mesh.steps`` and, under the default shift, ``mesh.hop_bytes``."""
    n_dev = mesh.size if n_dev is None else n_dev
    n_steps = _n_ring_steps(n_dev)
    if shift is None:
        def shift(vis):
            out = []
            for d in range(len(vis)):
                src = vis[(d - 1) % len(vis)]
                moved = src.to(mesh.devices[d])
                if moved.sizes.device != src.sizes.device:
                    count("mesh.hop_bytes", moved.nbytes())
                out.append(moved)
            return out
    out = [[None] * n_steps for _ in shards]
    vis = list(shards)
    with span("mesh.ring"):
        for t in range(n_steps):
            for d in range(len(shards)):
                out[d][t] = step(d, t, shards[d], vis[d])
            count("mesh.steps", len(shards))
            if t + 1 < n_steps:
                with span("mesh.hop"):
                    vis = shift(vis)
    return out


def _ids(shard) -> torch.Tensor:
    n = shard.sizes.shape[0]
    return shard.lo + torch.arange(n, dtype=torch.int64,
                                   device=shard.sizes.device)


# ---------------------------------------------------------------------------
# Ring steps: plain versions and wrappers

def ring_stats_step_plain(local: PlaneShard, visiting: PlaneShard, t: int,
                          n_dev: int, threshold: float, kmer_size: int,
                          radio: int) -> torch.Tensor:
    """One step of ``build_ring_fn``, the JAX step: ``_counts_block`` over
    plane 0 (512 rows at a time), the gates, ``_ownership_mask`` and the
    float32 distance (``ops/intersect.py::stats_epilogue``).  Returns (2,)
    int32: the step's count at ``threshold`` and the float32 bits of its
    minimum distance (1.0 when no pair passes)."""
    counts = torch.cat([pair_counts_plain(local.p0[r:r + 512], visiting.p0)
                        for r in range(0, local.p0.shape[0], 512)])
    return stats_epilogue(
        counts, local.sizes[:, None], visiting.sizes[None, :],
        _ownership_mask(t, n_dev, _ids(local), _ids(visiting)), radio,
        threshold, kmer_size)


def ring_stats_step(local: PlaneShard, visiting: PlaneShard, t: int,
                    n_dev: int, threshold: float, kmer_size: int,
                    radio: int) -> torch.Tensor:
    """One step of ``build_ring_fn``: (2,) int32 [count at ``threshold``,
    float32 bits of the minimum distance] of (local rows, visiting
    columns) on the local shard's device.  On the card one launch of K4's
    stats mode over the two shards' compact forms (plane 0), the tile kind
    taking the place of the ownership mask; nothing for the antipodal
    step's lower shard."""
    rows = local.p0.shape[0]
    if local.p0.device.type == "cpu":
        return ring_stats_step_plain(local, visiting, t, n_dev, threshold,
                                     kmer_size, radio)
    kind = _step_kind(t, n_dev, local.lo, visiting.lo)
    if kind == "none":
        return torch.tensor([0, int(np.float32(1.0).view(np.int32))],
                            dtype=torch.int32, device=local.p0.device)
    out = pair_stats_tiles(local.p0, local.sizes, [0], [0], [1], radio,
                           threshold, kmer_size, rows,
                           cols=(visiting.p0, visiting.sizes),
                           tri=kind == "self")
    LAUNCHES["ring_stats"] += 1
    return out


def ring_filter_mask_plain(local: BitShard, visiting: BitShard, t: int,
                           n_dev: int, scalars, radio: int,
                           is_containment: bool) -> torch.Tensor:
    """One bitmap/mask ring step's ``ok`` (rows, rows) bool, as the JAX
    step computes it: the shared-bit bound, nonzero sizes, the size-ratio
    gate (none for ``radio`` 0) and ``_ownership_mask``."""
    rows = local.xp.shape[0]
    ok = bm.tile_mask_plain(local.xp, local.coll, local.sizes, 0, 0, rows,
                            *scalars, radio, is_containment, "mst",
                            cols=(visiting.xp, visiting.coll,
                                  visiting.sizes), tri=False)
    return ok & _ownership_mask(t, n_dev, _ids(local), _ids(visiting))


def ring_masks_step(local: BitShard, visiting: BitShard, t: int, n_dev: int,
                    scalars, radio: int, is_containment: bool,
                    out: torch.Tensor, count: torch.Tensor,
                    counter: str = "ring_masks") -> None:
    """One step of ``build_ring_masks_fn`` and of ``build_ring_bitmap_fn``:
    the packed candidate mask of (local rows, visiting columns) into
    ``out`` (1, rows, rows // 8) uint8 (a step of the shard's slab, zeros
    on entry on the card) and its number of set bits added into ``count``
    (1,) int32 (zero on entry).  On the card one launch of the ring step's
    kernel (``csrc/ring_step.cu``) over the two shards' signatures, the
    tile kind taking the place of the ownership mask; the self step visits
    only the tiles with some j < i (the words above the diagonal keep
    their zeros).  Nothing is pulled.  The launch counts in
    ``LAUNCHES[counter]``."""
    rows = local.xp.shape[0]
    if local.xp.device.type == "cpu":
        ok = ring_filter_mask_plain(local, visiting, t, n_dev, scalars,
                                    radio, is_containment)
        out[0] = bm.pack_mask_u8(ok)
        count += ok.sum(dtype=torch.int32)
        return
    kind = _step_kind(t, n_dev, local.lo, visiting.lo)
    if kind == "none":
        return
    dev = local.xp.device
    for side in (local, visiting):
        bm._check_signatures(side.xp, side.coll, side.sizes, "mst", dev)
    if (out.dtype != torch.uint8 or not out.is_contiguous()
            or tuple(out.shape) != (1, rows, rows // 8) or out.device != dev
            or rows % 32 or visiting.xp.shape[0] != rows
            or count.dtype != torch.int32 or count.numel() != 1
            or count.device != dev):
        raise ValueError(f"out must be a contiguous (1, {rows}, {rows // 8})"
                         f" uint8 step and count a (1,) int32 tensor on "
                         f"{dev}, rows a multiple of 32 on both shards")
    bm.launch_ring_step((local.xp, local.coll, local.sizes),
                        (visiting.xp, visiting.coll, visiting.sizes),
                        (*scalars, radio), is_containment, kind == "self",
                        count, out)
    LAUNCHES[counter] += 1


def ring_bitmap_step_plain(local: BitShard, visiting: BitShard, t: int,
                           n_dev: int, scalars, radio: int,
                           is_containment: bool) -> torch.Tensor:
    """Plain bitmap ring step: the set positions of the step's mask."""
    ok = ring_filter_mask_plain(local, visiting, t, n_dev, scalars, radio,
                                is_containment)
    return torch.nonzero(ok.reshape(-1)).reshape(-1).to(torch.int32)


def ring_slabs(mesh: Mesh, shards: List[BitShard], scalars, radio: int,
               is_containment: bool, shift=None, n_dev: Optional[int] = None,
               wrap=None, counter: str = "ring_masks"):
    """The sweep of ``build_ring_masks_fn`` (and of ``build_ring_bitmap_fn``
    before its compaction) over ``_ring``: every local shard's resident
    slab (n_steps, rows, rows // 8) uint8, zeroed once, and its counts
    (n_steps,) int32, both on its device, and for every step the (row
    shard's, visiting shard's) first genome id.  ``shift`` and ``n_dev``
    go to ``_ring``; ``wrap(step)``, when given, returns the step function
    to run (a timer); ``counter`` names the steps' launch count.  No step
    reads anything back."""
    n_dev = mesh.size if n_dev is None else n_dev
    n_steps = _n_ring_steps(n_dev)
    rows = shards[0].xp.shape[0]
    slabs = [torch.zeros((n_steps, rows, rows // 8), dtype=torch.uint8,
                         device=dev) for dev in mesh.devices]
    counts = [torch.zeros(n_steps, dtype=torch.int32, device=dev)
              for dev in mesh.devices]

    def step(d, t, loc, vis):
        ring_masks_step(loc, vis, t, n_dev, scalars, radio, is_containment,
                        slabs[d][t:t + 1], counts[d][t:t + 1], counter)
        return loc.lo, vis.lo

    los = _ring(mesh, shards, step if wrap is None else wrap(step), shift,
                n_dev)
    return slabs, counts, los


def ring_positions(slab: torch.Tensor, counts: torch.Tensor, los,
                   record: Optional[dict] = None):
    """The close of ``build_ring_bitmap_fn`` on one shard: (on the card)
    one K3 launch over the slab straight from the ring's counts on the
    card, which writes each step's positions ``li * rows + vj`` in order,
    step after step (the steps with none are not read), then one pull of
    the counts and one of the positions (``_close_pulls``).  ``los``: each
    step's (row shard's, visiting shard's) first genome id.  Returns the
    global (ii, jj) int64 of every candidate, step after step.  ``record``,
    when given, gets the milliseconds up to the positions on the host
    appended to ``compact_ms``, those of the host decode to ``decode_ms``
    and, on the card, those of the close's parts to ``counts_ms``,
    ``k3_ms`` and ``copy_ms``."""
    t0 = time.perf_counter()
    rows = slab.shape[1]
    parts = {}
    if slab.device.type == "cuda":
        f, cnt = _close_pulls(slab, counts,
                              None if record is None else parts)
    else:
        cnt = counts.numpy().astype(np.int64)
        bm.account_pull(4 * len(cnt))
        f = bm.compact_steps(slab, counts).numpy()
    bm.account_pull(4 * len(f))
    t1 = time.perf_counter()
    li, vj = np.divmod(f, rows)
    row_lo, vis_lo = np.asarray(los, dtype=np.int64).reshape(-1, 2).T
    ii, jj = np.repeat(row_lo, cnt) + li, np.repeat(vis_lo, cnt) + vj
    if record is not None:
        record["compact_ms"].append(1e3 * (t1 - t0))
        parts["decode_ms"] = 1e3 * (time.perf_counter() - t1)
        for key, ms in parts.items():
            record.setdefault(key, []).append(ms)
    return ii, jj


# a pinned host buffer for each device's close positions, kept from call
# to call
_CLOSE_HOST: dict = {}


def _close_pulls(slab: torch.Tensor, counts: torch.Tensor,
                 parts: Optional[dict]):
    """K3 over ``slab`` into a ``bm.k3_buffer``, then one pull of
    ``counts`` (``bm.k3_complete`` launches K3 again when their total
    outgrew the buffer), then one pull of the positions into the pinned
    host buffer; all on the slab's device and its current stream.  Returns
    (positions, counts) as numpy arrays, the positions a view of the pinned
    buffer, valid until the next close on the device.  ``parts``, when
    given, receives the host wait for the counts (``counts_ms``: K3 runs
    ahead of them) and CUDA events' time of K3 (``k3_ms``) and of the
    positions copy (``copy_ms``)."""
    dev = slab.device
    with torch.cuda.device(dev):
        ev = None if parts is None else [
            torch.cuda.Event(enable_timing=True) for _ in range(4)]
        out = bm.k3_buffer(dev)
        if ev:
            ev[0].record()
        bm.compact_masks_into(slab, counts, out, out.numel(), codes="local")
        if ev:
            ev[1].record()
        t0 = time.perf_counter()
        cnt = _host_wait(_host_async(counts)).astype(np.int64)
        bm.account_pull(4 * len(cnt))
        t1 = time.perf_counter()
        total = int(cnt.sum())
        out = bm.k3_complete(slab, counts, out, total, codes="local")
        host = _CLOSE_HOST.get(dev)
        if host is None or host.numel() < total:
            host = _CLOSE_HOST[dev] = torch.empty(
                max(total, out.numel()), dtype=torch.int32, pin_memory=True)
        host = host[:total]
        done = ev[3] if ev else torch.cuda.Event()
        if ev:
            ev[2].record()
        host.copy_(out[:total], non_blocking=True)
        done.record()
        done.synchronize()
    if parts is not None:
        parts["counts_ms"] = 1e3 * (t1 - t0)
        parts["k3_ms"] = ev[0].elapsed_time(ev[1])
        parts["copy_ms"] = ev[2].elapsed_time(ev[3])
    return host.numpy(), cnt


def ring_edges_step_plain(local: PlaneShard, visiting: PlaneShard, t: int,
                          n_dev: int, radio: int):
    """Plain ``ring_edges_step``, the JAX step: ``_counts_block`` over the
    two shards' planes (512 rows at a time), ``counts > 0``, nonzero sizes,
    the size-ratio gate (none for ``radio`` 0) and ``_ownership_mask``."""
    counts = torch.cat([pair_counts_plain(
        local.p0[r:r + 512], visiting.p0,
        None if local.p1 is None else local.p1[r:r + 512], visiting.p1)
        for r in range(0, local.p0.shape[0], 512)])
    s0 = local.sizes[:, None]
    s1 = visiting.sizes[None, :]
    mn = torch.minimum(s0, s1)
    ok = (counts > 0) & (mn > 0)
    if radio:
        ok &= torch.maximum(s0, s1) <= radio * mn
    ok &= _ownership_mask(t, n_dev, _ids(local), _ids(visiting))
    with span("mesh.step_wait"):  # the step's size, as K3's total on the card
        flat = torch.nonzero(ok.reshape(-1)).reshape(-1)
    return flat.to(torch.int32), counts.reshape(-1)[flat]


def ring_edges_step(local: PlaneShard, visiting: PlaneShard, t: int,
                    n_dev: int, radio: int):
    """One step of ``build_ring_edges_fn``: (positions ``li * rows + vj``,
    exact common counts), int32, row-major, of the (local, visiting) pairs
    with a common hash that pass the gates.  On the card K4's mask mode
    over the two shards' compact forms, K3 from its count on the card, one
    pull of K3's total, then K5b on the survivors."""
    rows = local.p0.shape[0]
    if local.p0.device.type == "cpu":
        return ring_edges_step_plain(local, visiting, t, n_dev, radio)
    kind = _step_kind(t, n_dev, local.lo, visiting.lo)
    dev = local.p0.device
    if kind == "none":
        e = torch.empty(0, dtype=torch.int32, device=dev)
        return e, e.clone()
    cnts, packs = pair_mask_tiles(
        local.p0, local.p1, local.sizes, [0], [0], [1], radio, 0, rows, rows,
        cols=(visiting.p0, visiting.p1, visiting.sizes),
        tri=kind == "self")
    # K3 from K4's count on the card; the step's one sync is K3's total
    with span("mesh.step_wait"):
        flat = bm.compact_sized(packs, cnts, codes="local")
    pairs = torch.stack([flat // rows, flat % rows]).contiguous()
    common = pair_common_launch(local.p0, local.p1, pairs,
                                cols=(visiting.p0, visiting.p1))
    LAUNCHES["ring_edges"] += 1
    return flat, common


def dist_lp_round(mesh: Mesh, slabs: List[torch.Tensor], labels, clrs):
    """``dist_lp_round_fn``: every shard's slab (n_steps, shard, shard // 8)
    uint8 has the bits of its clear list ``clrs[d]`` ((4, C) int32 on its
    device: step, row, byte, bit value) cleared in place, then proposes
    under ``labels`` ((n_pad,) int32, one copy per distinct device in
    ``labels``, keyed by device).  Returns (row_p (n_pad,), fused [cross,
    col_p (n_pad,)]) int32 on the first device: each shard's rows'
    proposals, and the minimum and sum over the shards.  On the card K2
    over each slab (its tiles at (d·shard, b·shard)); on the CPU its plain
    version."""
    n_dev = mesh.size
    n_steps, shard, _ = slabs[0].shape
    n_pad = n_dev * shard
    home = mesh.devices[0]
    parts = []
    for d, dev in enumerate(mesh.devices):
        geo = _upload(np.array([[d * shard] * n_steps,
                                [((d - t) % n_dev) * shard
                                 for t in range(n_steps)],
                                [1] * n_steps]), dev)
        parts.append(lp_round(slabs[d], labels[dev], clrs[d], geo[0], geo[1],
                              geo[2], shard))
        if dev.type == "cuda":
            LAUNCHES["dist_lp_round"] += 1
    row_p = torch.cat([p[1 + d * shard:1 + (d + 1) * shard].to(home)
                       for d, p in enumerate(parts)])
    col_p = parts[0][1 + n_pad:].to(home)
    cross = parts[0][:1].to(home)
    for p in parts[1:]:
        col_p = torch.minimum(col_p, p[1 + n_pad:].to(home))  # pmin
        cross = cross + p[:1].to(home)  # psum
    return row_p, torch.cat([cross, col_p])


# ---------------------------------------------------------------------------
# Shards of the packed inputs, one per device

def _bit_shards(xp: np.ndarray, coll: np.ndarray, sizes: np.ndarray,
                mesh: Mesh, first_id: int = 0) -> List[BitShard]:
    """One shard of the rows a device; shard d's genomes are ids
    ``first_id + d * shard``, ... (a process's block in a multi-process
    mesh starts at its first genome)."""
    n_dev = mesh.size
    shard = xp.shape[0] // n_dev
    rows = _rows(shard, mesh, 8)  # whole bytes of a slab's mask rows
    out = []
    for d, dev in enumerate(mesh.devices):
        sl = slice(d * shard, (d + 1) * shard)
        x = np.zeros((rows, xp.shape[1]), dtype=np.uint8)
        c = np.zeros(rows, dtype=np.int32)
        s = np.zeros(rows, dtype=np.int32)
        x[:shard], c[:shard], s[:shard] = xp[sl], coll[sl], sizes[sl]
        out.append(BitShard(_to_device(x, dev), _to_device(c, dev),
                            _to_device(s, dev), first_id + d * shard))
    return out


def _plane_shards(plane0: np.ndarray, plane1: Optional[np.ndarray],
                  sizes: np.ndarray, mesh: Mesh,
                  first_pad_id: int) -> List[PlaneShard]:
    """Shards of the packed planes; rows past the logical shard are pads
    ``0x80000000 | id`` with ids from ``first_pad_id`` (each unique, so
    they match nothing)."""
    n_dev = mesh.size
    shard = plane0.shape[0] // n_dev
    rows = _rows(shard, mesh)
    extra = rows - shard
    out = []
    for d, dev in enumerate(mesh.devices):
        sl = slice(d * shard, (d + 1) * shard)
        pad_ids = first_pad_id + d * extra + np.arange(extra, dtype=np.uint32)
        pad = np.broadcast_to((np.uint32(0x80000000) | pad_ids)[:, None, None],
                              (extra,) + plane0.shape[1:])
        planes = [None if p is None else
                  _to_device(np.concatenate([p[sl], pad]).view(np.int32), dev)
                  for p in (plane0, plane1)]
        s = np.zeros(rows, dtype=np.int32)
        s[:shard] = sizes[sl]
        out.append(PlaneShard(planes[0], planes[1], _to_device(s, dev),
                              d * shard))
    return out


def _decode(out, shard: int, rows: int, n_dev: int):
    """Global (ii, jj) int64 and the block order of every step's positions
    ``li * rows + vj`` (device-major, then step), as the JAX ring's
    ``out_specs=P("data")`` stacks its blocks."""
    ii_all, jj_all = [], []
    for d in range(n_dev):
        for t, flat in enumerate(out[d]):
            f = flat.cpu().numpy().astype(np.int64)
            bm.account_pull(4 * len(f))
            b = (d - t) % n_dev
            ii_all.append(d * shard + f // rows)
            jj_all.append(b * shard + f % rows)
    if not ii_all:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy()
    return np.concatenate(ii_all), np.concatenate(jj_all)


# ---------------------------------------------------------------------------
# Stats ring

# Source: rabbittclust_tpu/parallel/dist_engine.py::distributed_candidate_stats
def distributed_candidate_stats(packed_plane0: np.ndarray, sizes: np.ndarray,
                                threshold: float, kmer_size: int,
                                mesh: Optional[Mesh] = None
                                ) -> Tuple[int, float]:
    """Run the full stats ring over a mesh; returns (# pairs with dist <=
    threshold, min pair distance), the distance in float32 as the JAX
    program computes it (a dry-run statistic: outputs written to files use
    float64 distances from exact counts).  ``packed_plane0`` (n, W, K)
    uint32 is a 32-bit pack's plane 0."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.size
    n = packed_plane0.shape[0]
    if n % n_dev != 0:
        raise ValueError(
            f"packed rows ({n}) must be a multiple of the mesh size "
            f"({n_dev}); pad with pack_sketches(pad_n_to=n_dev)")
    radio = size_ratio_limit(threshold, kmer_size - 1)
    shards = _plane_shards(packed_plane0, None, np.asarray(sizes), mesh,
                           first_pad_id=n)
    out = _ring(mesh, shards, lambda d, t, loc, vis: ring_stats_step(
        loc, vis, t, n_dev, threshold, kmer_size, radio))
    steps = np.stack([s.cpu().numpy() for o in out for s in o])
    total = int(steps[:, 0].astype(np.int64).sum())  # psum
    low = np.ascontiguousarray(steps[:, 1]).view(np.float32).min(
        initial=np.float32(1.0))  # pmin
    return total, float(low)


# ---------------------------------------------------------------------------
# Exact ring

# Source: rabbittclust_tpu/parallel/dist_engine.py::distributed_candidate_edges
def distributed_candidate_edges(packed_plane0: np.ndarray,
                                sizes: np.ndarray, threshold: float,
                                kmer_size: int, mesh: Optional[Mesh] = None,
                                radio: Optional[int] = None,
                                packed_plane1: Optional[np.ndarray] = None):
    """Exact candidate edges (i, j, common) across the mesh, every pair
    covered exactly once (pair ownership: global_i > global_j), in the JAX
    ring's order.

    ``radio`` overrides the size-ratio prefilter; default (None) is the
    reference's int-truncated MST prefilter (size_ratio_limit with k-1);
    ``radio=0`` disables the gate.  ``packed_plane1`` enables 64-bit KSSD
    hashes (two uint32 planes per slot).  Each step's output is sized from
    K4's exact count, so the JAX function's ``cap`` has no counterpart."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.size
    n = packed_plane0.shape[0]
    if n % n_dev != 0:
        raise ValueError(
            f"packed rows ({n}) must be a multiple of the mesh size "
            f"({n_dev}); pad with pack_sketches(pad_n_to=n_dev)")
    if radio is None:
        radio = size_ratio_limit(threshold, kmer_size - 1)
    shard = n // n_dev
    rows = _rows(shard, mesh)
    with span("mesh.upload"):
        shards = _plane_shards(packed_plane0, packed_plane1,
                               np.asarray(sizes), mesh, first_pad_id=n)
    out = _ring(mesh, shards, lambda d, t, loc, vis: ring_edges_step(
        loc, vis, t, n_dev, radio))
    with span("mesh.decode"):
        ii, jj = _decode([[f for f, _ in o] for o in out], shard, rows,
                         n_dev)
        cc = [c.cpu().numpy().astype(np.int64) for o in out for _, c in o]
        cc = np.concatenate(cc) if cc else np.empty(0, dtype=np.int64)
    # canonical host orientation (i > j) — see the bitmap ring decode
    return np.maximum(ii, jj), np.minimum(ii, jj), cc


# Source: rabbittclust_tpu/parallel/dist_engine.py::_pack_rows_for_mesh
def _pack_rows_for_mesh(hashes, mesh: Mesh):
    """Bucket-pack sketches (32- or 64-bit) with rows padded to a mesh
    multiple; returns (plane0, plane1-or-None, sizes)."""
    n_dev = mesh.size
    n = len(hashes)
    use64 = n > 0 and hashes[0].dtype == np.uint64
    pad = ((n + n_dev - 1) // n_dev) * n_dev
    packed = pack_sketches(hashes, use64, pad_n_to=max(pad, n_dev))
    plane0 = packed.plane0[:pad] if packed.plane0.shape[0] >= pad \
        else packed.plane0
    plane1 = (None if packed.plane1 is None
              else packed.plane1[:plane0.shape[0]])
    return plane0, plane1, packed.sizes[:plane0.shape[0]]


# ---------------------------------------------------------------------------
# Bitmap ring

# Source: rabbittclust_tpu/parallel/dist_engine.py::
# distributed_candidate_pairs_bitmap
def distributed_candidate_pairs_bitmap(hashes, threshold: float,
                                       kmer_size: int,
                                       is_containment: bool = False,
                                       mesh: Optional[Mesh] = None,
                                       bits: int = 8192,
                                       radio: Optional[int] = None):
    """Bitmap-filter candidates (i > j, unverified) over a device mesh, in
    the JAX ring's order: no false negatives for pairs reachable at
    distance <= threshold (and passing the size-ratio prefilter), so
    downstream exact verification reproduces host results bit-exactly.
    The ring's steps fill each shard's slab on its device; after the last
    step one K3 launch a shard compacts it from the counts on the card,
    and its counts and positions are pulled (no ``cap``)."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.size
    n = len(hashes)
    xp, coll = bm.pack_bitmaps_packed(hashes, bits=bits, pad_n_to=n_dev)
    n_pad = xp.shape[0]
    sizes = np.zeros(n_pad, dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    if radio is None:
        radio = size_ratio_limit(threshold, kmer_size - 1)
    scalars = (np.float32(j_min), np.float32(1.0 + j_min), np.float32(c_min))
    slabs, counts, los = ring_slabs(mesh, _bit_shards(xp, coll, sizes, mesh),
                                    scalars, radio, is_containment,
                                    counter="ring_bitmap")
    parts = [ring_positions(slabs[d], counts[d], los[d])
             for d in range(n_dev)]
    ii = np.concatenate([p[0] for p in parts])
    jj = np.concatenate([p[1] for p in parts])
    # canonical host orientation (i > j): interior triangular-ring steps
    # emit row-id-first pairs where the row id may be the smaller one
    ii, jj = np.maximum(ii, jj), np.minimum(ii, jj)
    keep = (ii < n) & (jj < n)  # drop padded rows
    return ii[keep], jj[keep]


# Source: rabbittclust_tpu/parallel/dist_engine.py::distributed_mst
def distributed_mst(hashes, threshold: float, kmer_size: int,
                    is_containment: bool = False, mesh: Optional[Mesh] = None,
                    engine: str = "auto", bits: int = 8192,
                    full_mst: bool = False):
    """MST over a device mesh (edge-partition MST theorem).

    engine="auto" (default) selects by use: the "bitmap" ring when the MST
    only needs to be exact for cuts <= ``threshold``, the "exact" ring when
    ``full_mst=True`` (the MST is persisted as edge.mst and re-cut at any
    threshold).

    engine="exact": exact-count ring -> float64 distances on the host ->
    Kruskal.  The candidate set is every pair with common >= 1 passing the
    size-ratio prefilter — byte-equal to the host compute_mst, valid for
    cuts at ANY threshold.

    engine="bitmap": bitmap-filter ring + native exact verify.  The
    candidate bound is threshold-dependent, so the returned MST is exact for
    every cut <= threshold but may lack candidate edges above it."""
    if mesh is None:
        mesh = make_mesh()
    count("mesh.cards", mesh.size)
    if engine == "auto":
        engine = "exact" if full_mst else "bitmap"
    if engine == "bitmap":
        n = len(hashes)
        ii, jj = distributed_candidate_pairs_bitmap(
            hashes, threshold, kmer_size, is_containment=is_containment,
            mesh=mesh, bits=bits)
        common = bm.CsrSketches(hashes).count_common(ii, jj).astype(np.int64)
        nz = common > 0
        ii, jj, common = ii[nz], jj[nz], common[nz]
        s = np.array([len(h) for h in hashes], dtype=np.int64)
        if is_containment:
            d = aaf_distance(common, s[ii], s[jj], kmer_size)
        else:
            d = mash_distance(common, s[ii], s[jj], kmer_size)
        return MstResult(mst=kruskal((ii, jj, d), n), n=n)
    n = len(hashes)
    with span("mesh.pack"):
        plane0, plane1, sizes = _pack_rows_for_mesh(hashes, mesh)
    ii, jj, common = distributed_candidate_edges(
        plane0, sizes, threshold, kmer_size, mesh=mesh, packed_plane1=plane1)
    with span("mesh.kruskal"):
        keep = (ii < n) & (jj < n)
        ii, jj, common = ii[keep], jj[keep], common[keep]
        count("mesh.candidates", len(ii))
        s = np.array([len(h) for h in hashes], dtype=np.int64)
        if is_containment:
            d = aaf_distance(common, s[ii], s[jj], kmer_size)
        else:
            d = mash_distance(common, s[ii], s[jj], kmer_size)
        mst = kruskal((ii, jj, d), n)
    if mesh.cuda:
        count("mesh.card_peak_bytes", max(
            torch.cuda.max_memory_allocated(dev)
            for dev in dict.fromkeys(mesh.devices)))
    return MstResult(mst=mst, n=n)


# Source: rabbittclust_tpu/parallel/dist_engine.py::
# distributed_similarity_graph
def distributed_similarity_graph(hashes, threshold: float, kmer_size: int,
                                 mesh: Optional[Mesh] = None,
                                 bits: int = 8192):
    """Leiden similarity graph over the mesh: edge iff dist < threshold and
    size ratio >= 0.5, weight = 1 - dist (leiden.cpp:188-256 semantics);
    the edge set and float64 weights of cluster.leiden.build_similarity_graph
    (no kNN)."""
    if mesh is None:
        mesh = make_mesh()
    # superset of both the Mash bound max <= min * (2e^{dk}-1) and the
    # Leiden ratio >= 0.5 window
    radio_safe = max(2, int(math.ceil(2.0 * math.exp(
        threshold * kmer_size))) + 1)
    ii, jj = distributed_candidate_pairs_bitmap(
        hashes, threshold, kmer_size, mesh=mesh, bits=bits, radio=radio_safe)
    common = bm.CsrSketches(hashes).count_common(ii, jj).astype(np.int64)
    nz = common > 0
    ii, jj, common = ii[nz], jj[nz], common[nz]
    s = np.array([len(h) for h in hashes], dtype=np.int64)
    s0, s1 = s[ii], s[jj]
    ratio = np.minimum(s0, s1) / np.maximum(np.maximum(s0, s1), 1)
    d = np.clip(mash_distance(common, s0, s1, kmer_size), 0.0, 1.0)
    ok = (ratio >= 0.5) & (d < threshold)
    frm = np.minimum(ii[ok], jj[ok])
    to = np.maximum(ii[ok], jj[ok])
    return frm, to, 1.0 - d[ok]


# Source: rabbittclust_tpu/parallel/dist_engine.py::
# distributed_threshold_clusters
def distributed_threshold_clusters(hashes, threshold: float, kmer_size: int,
                                   is_containment: bool = False,
                                   mesh: Optional[Mesh] = None,
                                   bits: int = 8192,
                                   engine: str = "bitmap"):
    """Exact single-linkage clusters at ``threshold`` over a device mesh
    (BFS-ordered like the reference MST cut): the bitmap-filter ring +
    union-find-gated native exact verify, or with engine="exact" the
    exact-count ring's MST cut."""
    if engine == "exact":
        res = distributed_mst(hashes, threshold, kmer_size,
                              is_containment=is_containment, mesh=mesh,
                              engine="exact")
        return clusters_from_forest(cut_forest(res.mst, threshold),
                                    len(hashes))
    n = len(hashes)
    if n == 0:
        return []
    ii, jj = distributed_candidate_pairs_bitmap(
        hashes, threshold, kmer_size, is_containment=is_containment,
        mesh=mesh, bits=bits)
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    uf = UnionFind(n)
    csr = bm.CsrSketches(hashes)
    kept_i: list = []
    kept_j: list = []
    kept_d: list = []
    _gated_verify_block(uf, csr, sizes, ii, jj, threshold, kmer_size,
                        is_containment, kept_i, kept_j, kept_d)
    forest = kruskal((np.asarray(kept_i, dtype=np.int64),
                      np.asarray(kept_j, dtype=np.int64),
                      np.asarray(kept_d, dtype=np.float64)), n)
    return clusters_from_forest(forest, n)


# ---------------------------------------------------------------------------
# Distributed label propagation: resident mask slabs, one per shard

def build_ring_masks(mesh: Mesh, shards: List[BitShard], scalars,
                     radio: int, is_containment: bool) -> List[torch.Tensor]:
    """``build_ring_masks_fn``: one ring sweep writing each shard's
    resident (n_steps, rows, rows // 8) uint8 slab, every unordered pair
    once (ownership as ``_ownership_mask``)."""
    return ring_slabs(mesh, shards, scalars, radio, is_containment)[0]


# Source: rabbittclust_tpu/parallel/dist_engine.py::_dist_lp_clear
def _dist_lp_clear(fi, fj, shard: int, n_dev: int, n_steps: int):
    """Host-side clear-list encode for the mesh slabs: pair (i > j) ->
    (device, step, local row, byte, bit) under the triangular ownership
    rule (mirrors _ownership_mask; each bit exists on exactly one
    device/step).  Returns (D*C,) arrays, C ladder-padded per device."""
    a = fi // shard
    b = fj // shard
    t_ab = (a - b) % n_dev
    own_a = t_ab < n_steps
    dev = np.where(own_a, a, b)
    stp = np.where(own_a, t_ab, (b - a) % n_dev)
    row = np.where(own_a, fi % shard, fj % shard)
    col = np.where(own_a, fj % shard, fi % shard)
    per_dev = np.bincount(dev, minlength=n_dev) if len(dev) else \
        np.zeros(n_dev, dtype=np.int64)
    cap = _clear_quantum(int(per_dev.max()) if len(dev) else 0)
    ct = np.zeros((n_dev, cap), dtype=np.int32)
    cr = np.zeros((n_dev, cap), dtype=np.int32)
    cb = np.zeros((n_dev, cap), dtype=np.int32)
    cs = np.zeros((n_dev, cap), dtype=np.uint8)
    fill = np.zeros(n_dev, dtype=np.int64)
    for k in range(len(dev)):
        dv = int(dev[k])
        p = fill[dv]
        fill[dv] += 1
        ct[dv, p] = stp[k]
        cr[dv, p] = row[k]
        cb[dv, p] = col[k] // 8
        cs[dv, p] = 1 << (col[k] % 8)
    return (ct.reshape(-1), cr.reshape(-1), cb.reshape(-1),
            cs.reshape(-1), cap)


def _ms(events) -> List[float]:
    return [a.elapsed_time(z) for a, z in events]


# Source: rabbittclust_tpu/parallel/dist_engine.py::
# distributed_threshold_clusters_lp
def distributed_threshold_clusters_lp(hashes, threshold: float,
                                      kmer_size: int,
                                      is_containment: bool = False,
                                      mesh: Optional[Mesh] = None,
                                      bits: int = 8192,
                                      max_rounds: int = 256):
    """Exact single-linkage clusters over the mesh via resident-mask label
    propagation.  Per-device memory is N^2/8/n_dev mask bytes; per-round
    host traffic is O(N).  Exactness: the slabs jointly hold every
    unordered pair exactly once (triangular ownership), rounds only retire
    pairs by verified merge, verified clear, or same-label gating."""
    n = len(hashes)
    if n == 0:
        return []
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.size
    n_steps = _n_ring_steps(n_dev)
    clock = time.perf_counter
    # shard rows must divide by 8 (bit-packed mask columns); 128 also
    # gives K2 its 16-byte row chunks
    n_pad = max(-(-n // (n_dev * 128)), 1) * n_dev * 128
    shard = n_pad // n_dev
    if mesh.cuda and shard > MAX_RB:
        raise ValueError(
            f"{n} genomes over {n_dev} shards: a shard of {shard} rows; K2 "
            f"takes row blocks of at most {MAX_RB}, so on the card a shard "
            f"holds at most {MAX_RB} rows (use more shards)")
    xp, coll = bm.pack_bitmaps_packed(hashes, bits=bits,
                                      pad_n_to=n_dev * 128)
    assert xp.shape[0] == n_pad
    sizes = np.zeros(n_pad, dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    radio = size_ratio_limit(threshold, kmer_size - 1)
    scalars = (np.float32(j_min), np.float32(1.0 + j_min), np.float32(c_min))

    events: dict = {"build": [], "round": []}

    def timed(key, fn, *args):
        if not mesh.cuda:
            return fn(*args)
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        out = fn(*args)
        ev1.record()
        events[key].append((ev0, ev1))
        return out

    shards = _bit_shards(xp, coll, sizes, mesh)
    slabs = timed("build", build_ring_masks, mesh, shards, scalars, radio,
                  is_containment)
    del shards
    uf = UnionFind(n)
    csr = bm.CsrSketches(hashes)
    sizes64 = sizes.astype(np.int64)
    kept_i: list = []
    kept_j: list = []
    kept_d: list = []
    distinct = list(dict.fromkeys(mesh.devices))

    def labels_arr():
        roots = np.full(n_pad, -1, dtype=np.int32)
        roots[:n] = uf.roots_array()[:n]
        roots[n:] = n + np.arange(n_pad - n, dtype=np.int32)
        return roots

    cap = _clear_quantum(0)
    clr = np.zeros(n_dev * 4 * cap, dtype=np.int32)
    rounds = 0
    g = np.arange(n_pad, dtype=np.int64)
    t_host = clock()
    while rounds < max_rounds:
        rounds += 1
        lab = labels_arr()
        labels = {dev: _upload(lab, dev) for dev in distinct}
        per_dev = clr.reshape(n_dev, 4, -1)
        clrs = [_upload(per_dev[d], dev) for d, dev in enumerate(mesh.devices)]
        row_p_dev, fused_dev = timed("round", dist_lp_round, mesh, slabs,
                                     labels, clrs)
        row_p = row_p_dev.cpu().numpy()
        fused = fused_dev.cpu().numpy()
        bm.account_pull(row_p.nbytes + fused.nbytes)
        cross = int(fused[0])
        if cross == 0:
            break
        col_p = fused[1:]
        rp = row_p < SENT
        ri, rj = g[rp], row_p[rp].astype(np.int64)
        ki, kj, kd, ok_r = gated_verify_merge(
            uf, csr, sizes64, ri, rj, threshold, kmer_size, is_containment)
        kept_i.extend(ki.tolist())
        kept_j.extend(kj.tolist())
        kept_d.extend(kd.tolist())
        cp = col_p < SENT
        ci, cj = col_p[cp].astype(np.int64), g[cp]
        roots = uf.roots_array()
        alive = roots[ci] != roots[cj]
        ci, cj = ci[alive], cj[alive]
        ki, kj, kd, ok_c = gated_verify_merge(
            uf, csr, sizes64, ci, cj, threshold, kmer_size, is_containment)
        kept_i.extend(ki.tolist())
        kept_j.extend(kj.tolist())
        kept_d.extend(kd.tolist())
        fi = np.concatenate([ri[~ok_r], ci[~ok_c]])
        fj = np.concatenate([rj[~ok_r], cj[~ok_c]])
        if len(fi):
            _, sel = np.unique(fi * n_pad + fj, return_index=True)
            fi, fj = fi[sel], fj[sel]
        ct, cr, cb, cs, cap2 = _dist_lp_clear(fi, fj, shard, n_dev,
                                              n_steps)
        # device-major layout: per device [t, r, b, sub] (C each)
        clr = np.concatenate(
            [ct.reshape(n_dev, cap2), cr.reshape(n_dev, cap2),
             cb.reshape(n_dev, cap2),
             cs.reshape(n_dev, cap2).astype(np.int32)],
            axis=1).reshape(-1)
    else:
        # pathological-input fallback: pull the remaining slabs once and
        # finish with the gated host verifier — exact, just no longer
        # O(N)-pull
        for dv in range(n_dev):
            mk = slabs[dv].cpu().numpy()
            bm.account_pull(mk.nbytes)
            for t in range(n_steps):
                bits2d = np.unpackbits(mk[t], axis=1, bitorder="little")
                il, jl = np.nonzero(bits2d)
                ii = il.astype(np.int64) + dv * shard
                jj = jl.astype(np.int64) + ((dv - t) % n_dev) * shard
                ii, jj = np.maximum(ii, jj), np.minimum(ii, jj)
                inb = (ii < n) & (jj < n)
                ii, jj = ii[inb], jj[inb]
                roots = uf.roots_array()
                keep = roots[ii] != roots[jj]
                _gated_verify_block(uf, csr, sizes64, ii[keep], jj[keep],
                                    threshold, kmer_size, is_containment,
                                    kept_i, kept_j, kept_d)
    host_s = clock() - t_host

    DIST_LP_LAST.clear()
    DIST_LP_LAST.update(rounds=rounds, n_pad=n_pad, n_dev=n_dev, bits=bits,
                        rounds_s=host_s)
    if mesh.cuda:
        for dev in distinct:
            torch.cuda.synchronize(dev)
        DIST_LP_LAST.update(build_ms=_ms(events["build"])[0],
                            round_ms=_ms(events["round"]))
    forest = sort_edges((np.asarray(kept_i, dtype=np.int64),
                         np.asarray(kept_j, dtype=np.int64),
                         np.asarray(kept_d, dtype=np.float64)))
    return clusters_from_forest(forest, n)


# Source: rabbittclust_tpu/parallel/dist_engine.py::dist_lp_comm_stats
def dist_lp_comm_stats(n_pad: int, n_dev: int, bits: int, rounds: int
                       ) -> dict:
    """Per-device communication volume of the mesh labelprop engine.

    Analytic, not sampled: build ring: ``n_steps`` hops each moving vxp
    (shard x bits/8 u8) + vcoll/vsizes/vis_ids (shard i32); each round: a
    minimum over col_p (n_pad i32) + a sum of one i32, costed at the
    ring-allreduce volume 2(n_dev-1)/n_dev x payload per device."""
    shard = n_pad // max(n_dev, 1)
    n_steps = _n_ring_steps(n_dev)
    # a 1-device "ring" self-permutes in device memory: nothing crosses
    hop = (shard * (bits // 8) + 3 * shard * 4) if n_dev > 1 else 0
    ar = 2.0 * (n_dev - 1) / max(n_dev, 1)
    per_round = int(ar * (n_pad * 4 + 4))
    return {
        "ici_bytes_per_hop": hop,
        "build_hops": n_steps,
        "build_ici_bytes_per_device": n_steps * hop,
        "allreduce_bytes_per_round_per_device": per_round,
        "rounds": rounds,
        "total_ici_bytes_per_device": n_steps * hop + rounds * per_round,
    }


# Source: rabbittclust_tpu/parallel/dist_engine.py::ring_comm_stats
def ring_comm_stats(n_pad: int, n_dev: int, row_bytes: int,
                    extra_i32_vectors: int = 3) -> dict:
    """Per-device volume of the ring engines (the bitmap and exact rings):
    each of the n_steps hops moves the visiting shard's payload (shard x
    row_bytes) plus ``extra_i32_vectors`` shard-length i32 vectors
    (sizes/ids/collision counts)."""
    shard = n_pad // max(n_dev, 1)
    n_steps = _n_ring_steps(n_dev)
    hop = (shard * row_bytes + extra_i32_vectors * shard * 4) \
        if n_dev > 1 else 0
    return {
        "ici_bytes_per_hop": hop,
        "hops": n_steps,
        "total_ici_bytes_per_device": n_steps * hop,
    }
