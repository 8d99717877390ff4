"""Bucketed dense packing of variable-size sketches for the pair engine,
and the packed planes on the device: the state the MST engine keeps
resident.

Variable-size sorted hash arrays don't tile; the device engine instead
operates on a dense per-genome layout:

    plane0[g, w, k] (uint32), optionally plane1[g, w, k] for 64-bit hashes

where k indexes K hash-space buckets and w indexes W slots per bucket.
Bucketing uses a *bijective* mix (Knuth/Fibonacci multiplicative hashing) so
that equality of stored values within a bucket is exactly equality of the
original hashes:

  32-bit: m = h * 2654435761 mod 2^32 (bijection);  bucket = m >> (32-b);
          stored value = m & (2^(32-b) - 1)  < 2^(32-b)  (top bit clear).
  64-bit: m = h * 0x9E3779B97F4A7C15 mod 2^64 (bijection); bucket = m >>
          (64-b); plane0 = m & 0xFFFFFFFF, plane1 = (m >> 32) & (2^(32-b)-1).

Padding: empty slots are filled with 0x80000000 | genome_id (in plane1 for
the 64-bit layout).  Real values never have the top bit set, and pads of
*different* genomes never equal each other, so a cross-genome equality is
always a true hash match — no pad correction term is needed.

W is the max bucket occupancy over the dataset (rounded up to a multiple of
4); b adapts upward if W would exceed ``max_width``.

Slot order: the real entries of a (genome, bucket) fill slots 0..occ-1
and pads the rest (the stable sort by cell numbers them from 0).
``compact_planes`` keeps only the real entries, in the two orders the
device kernels read; it finds them by the pad test, so it does not rely
on the slot order.  Its grouped order holds each (group, bucket) segment
sorted by value, so that K4 joins two segments by search instead of
comparing every pair of their entries.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List, Optional

import numpy as np
import torch

_MIX32 = np.uint32(2654435761)
_MIX64 = np.uint64(0x9E3779B97F4A7C15)


# Source: rabbittclust_tpu/ops/pack.py::PackedSketches
@dataclass
class PackedSketches:
    plane0: np.ndarray            # (N, W, K) uint32
    plane1: Optional[np.ndarray]  # (N, W, K) uint32 or None (32-bit hashes)
    sizes: np.ndarray             # (N,) int32 — true sketch sizes
    bucket_bits: int
    width: int

    @property
    def n(self) -> int:
        return self.plane0.shape[0]

    @property
    def k(self) -> int:
        return self.plane0.shape[2]


# Source: rabbittclust_tpu/ops/pack.py::_round_up
def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Source: rabbittclust_tpu/ops/pack.py::pack_sketches
def pack_sketches(hashes: List[np.ndarray], use64: bool,
                  bucket_bits: Optional[int] = None,
                  max_width: int = 32, pad_n_to: int = 8) -> PackedSketches:
    n = len(hashes)
    sizes = np.array([len(h) for h in hashes], dtype=np.int32)
    avg = max(int(sizes.mean()) if n else 1, 1)
    if bucket_bits is None:
        bucket_bits = max(6, int(np.ceil(np.log2(avg))))
    total_bits = 64 if use64 else 32

    while True:
        k = 1 << bucket_bits
        shift = np.uint64(total_bits - bucket_bits) if use64 else \
            np.uint32(total_bits - bucket_bits)
        # flatten and mix
        gid = np.concatenate(
            [np.full(len(hashes[i]), i, dtype=np.int64) for i in range(n)]) \
            if n else np.empty(0, dtype=np.int64)
        hv = np.concatenate([np.asarray(h) for h in hashes]) if n else \
            np.empty(0, dtype=np.uint64 if use64 else np.uint32)
        with np.errstate(over="ignore"):
            if use64:
                m = hv.astype(np.uint64) * _MIX64
                bucket = (m >> shift).astype(np.int64)
                v0 = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                v1 = ((m >> np.uint64(32)) &
                      np.uint64((1 << (32 - bucket_bits)) - 1
                                if bucket_bits < 32 else 0)).astype(np.uint32)
            else:
                m = hv.astype(np.uint32) * _MIX32
                bucket = (m >> shift).astype(np.int64)
                v0 = (m & np.uint32((1 << (32 - bucket_bits)) - 1)).astype(
                    np.uint32)
                v1 = None
        # occupancy per (genome, bucket)
        cell = gid * k + bucket
        if len(cell):
            order = np.argsort(cell, kind="stable")
            cell_s = cell[order]
            starts = np.flatnonzero(np.r_[True, cell_s[1:] != cell_s[:-1]])
            lens = np.diff(np.r_[starts, len(cell_s)])
            width = int(lens.max())
        else:
            order = cell.astype(np.int64)
            starts = np.empty(0, dtype=np.int64)
            lens = np.empty(0, dtype=np.int64)
            width = 1
        if width <= max_width or bucket_bits >= total_bits - 1:
            break
        bucket_bits += 1

    w = max(_round_up(width, 4), 4)
    n_pad = max(_round_up(n, pad_n_to), pad_n_to)
    # per-genome pads: top bit set + genome id -> cross-genome inequality
    pad_col = (np.uint32(0x80000000) |
               np.arange(n_pad, dtype=np.uint32))[:, None, None]
    plane0 = np.broadcast_to(pad_col, (n_pad, w, k)).copy()
    plane1 = np.broadcast_to(pad_col, (n_pad, w, k)).copy() if use64 else None
    if len(cell):
        slot = np.arange(len(cell_s)) - np.repeat(starts, lens)
        g_s = cell_s // k
        b_s = cell_s % k
        plane0[g_s, slot, b_s] = v0[order]
        if use64:
            plane1[g_s, slot, b_s] = v1[order]
    sizes_pad = np.zeros(n_pad, dtype=np.int32)
    sizes_pad[:n] = sizes
    return PackedSketches(plane0=plane0, plane1=plane1, sizes=sizes_pad,
                          bucket_bits=bucket_bits, width=w)


@dataclass
class DevicePlanes:
    plane0: torch.Tensor            # (n_pad, W, K) int32 view of uint32
    plane1: Optional[torch.Tensor]  # same, 64-bit hashes only
    sizes: torch.Tensor             # (n_pad,) int32

    @property
    def two_plane(self) -> bool:
        return self.plane1 is not None

    def compact(self) -> "CompactPlanes":
        """The planes' compact form, built at the first call."""
        return compact_of(self.plane0, self.plane1)


# Genomes of a group in the grouped order: the edge of K4's block tile
# (csrc/pair_counts.cu::GS).
GROUP = 128
# bucket window lengths the tile kernel may stage at a time
WINDOWS = (32, 16, 8, 4, 2, 1)
# spare elements after every value array: the kernels copy 16-byte
# granules and may read up to 15 bytes past a segment
SPARE = 16
# the compact form's layout, part of the key a kept form is found by: 2
# since its grouped segments are sorted by value
LAYOUT = 2


@dataclass
class CompactPlanes:
    """The real entries of the planes (top bit clear in the top plane:
    plane1 for 64-bit hashes, where a real plane0 value may have its top
    bit set), in two orders:

    * genome-major, read by K5b: ``v0``/``v1`` hold genome g's entries in
      (bucket, slot) order from ``start[g]``; ``occ[g, k]`` counts them.
    * grouped, read by K4: genomes in groups of ``GROUP``; ``g0``/``g1``
      hold group G's entries bucket by bucket from ``start[GROUP * G]``,
      ``gid`` the genome within the group of each, and ``goff[G, k]`` is
      the first entry of bucket k within the group.  Each (group, bucket)
      segment is sorted by value (``sort_key``: unsigned, ``(g1, g0)``
      for 64-bit hashes), ties by ``gid``.

    ``padsq[g]`` is the sum over buckets of (W - occ)^2: the matches of
    genome g's pads with its own pads, which the plain count has on the
    diagonal.  ``window_max[wb]`` is the most entries any group holds in
    one window of ``wb`` buckets (windows start at multiples of ``wb``)."""
    v0: torch.Tensor              # (E + SPARE,) int32
    v1: Optional[torch.Tensor]    # (E + SPARE,) int32, 64-bit hashes only
    g0: torch.Tensor              # (E + SPARE,) int32
    g1: Optional[torch.Tensor]
    gid: torch.Tensor             # (E + SPARE,) uint8
    occ: torch.Tensor             # (n_pad, K) uint8
    start: torch.Tensor           # (n_groups * GROUP + 1,) int64
    goff: torch.Tensor            # (n_groups, K + 1) int32
    padsq: torch.Tensor           # (n_pad,) int32 (int32 arithmetic)
    window_max: dict

    @property
    def entries(self) -> int:
        return int(self.start[-1])

    def to(self, device: torch.device) -> "CompactPlanes":
        """The same form on ``device`` (itself when it is there)."""
        moved = {f.name: getattr(self, f.name) for f in fields(self)}
        for name, val in moved.items():
            if isinstance(val, torch.Tensor):
                moved[name] = val.to(device)
        return CompactPlanes(**moved)


def sort_key(v0: torch.Tensor, v1: Optional[torch.Tensor]) -> torch.Tensor:
    """int64 key of entries with int32 values ``v0`` (and ``v1``): the
    value read unsigned, ``v1`` the high word (csrc/pair_counts.cu::key_at
    orders them the same way; a real ``v1`` has its top bit clear)."""
    key = v0.long() & 0xFFFFFFFF
    return key if v1 is None else key | (v1.long() << 32)


def _sort_segments(seg_len: torch.Tensor, cols: dict) -> dict:
    """The grouped entries ``cols`` (name: 1-D tensor, segment by segment,
    ``seg_len`` entries each, genome order within a segment) with every
    segment sorted by ``sort_key``, ties kept in genome order (two stable
    sorts: by value, then by segment)."""
    seg = torch.repeat_interleave(
        torch.arange(len(seg_len), device=seg_len.device), seg_len)
    order = torch.sort(sort_key(cols["g0"], cols.get("g1")),
                       stable=True).indices
    order = order[torch.sort(seg[order], stable=True).indices]
    return {name: col[order] for name, col in cols.items()}


def compact_planes(p0: torch.Tensor, p1: Optional[torch.Tensor],
                   chunk_groups: int = 8) -> CompactPlanes:
    """The compact form of (n_pad, W, K) int32 planes, on their device.
    Plain torch: it is layout.  Genomes are read ``chunk_groups`` groups at
    a time, so the temporaries stay small beside the planes; a chunk holds
    whole groups, so its segments are sorted within it."""
    n, w, k = p0.shape
    dev = p0.device
    top = p0 if p1 is None else p1
    n_groups = max(-(-n // GROUP), 1)
    n_virt = n_groups * GROUP
    step = chunk_groups * GROUP
    occ = torch.zeros((n_virt, k), dtype=torch.int32, device=dev)
    for lo in range(0, n, step):
        occ[lo:lo + step] = (top[lo:lo + step] >= 0).sum(1, dtype=torch.int32)
    start = torch.zeros(n_virt + 1, dtype=torch.int64, device=dev)
    start[1:] = occ.sum(1, dtype=torch.int64).cumsum(0)
    goff = torch.zeros((n_groups, k + 1), dtype=torch.int64, device=dev)
    goff[:, 1:] = occ.view(n_groups, GROUP, k).sum(
        1, dtype=torch.int64).cumsum(1)
    if n and int(goff[:, -1].max()) >= 2 ** 31:
        raise ValueError("a group of genomes holds 2^31 entries or more")
    edges = {wb: torch.tensor(list(range(0, k, wb)) + [k], device=dev)
             for wb in WINDOWS}
    window_max = dict(zip(WINDOWS, torch.stack([
        (goff[:, e[1:]] - goff[:, e[:-1]]).max() for e in edges.values()
    ]).tolist()))
    parts = {"v0": [], "v1": [], "g0": [], "g1": [], "gid": []}
    ids = torch.arange(GROUP, dtype=torch.uint8, device=dev)
    for lo in range(0, n_virt, step):
        hi = min(lo + step, n_virt)
        real = top[lo:hi] >= 0
        short = hi - lo - real.shape[0]  # the virtual genomes of the tail
        real = torch.cat([real, real.new_zeros((short, w, k))])
        gm = real.transpose(1, 2)  # (genome, bucket, slot)
        gr = real.view(-1, GROUP, w, k).permute(0, 3, 1, 2)
        grouped = {}
        for name, plane in (("0", p0), ("1", p1)):
            if plane is None:
                continue
            vals = plane[lo:hi]
            vals = torch.cat([vals, vals.new_zeros((short, w, k))])
            parts["v" + name].append(vals.transpose(1, 2).masked_select(gm))
            grouped["g" + name] = vals.view(-1, GROUP, w, k).permute(
                0, 3, 1, 2).masked_select(gr)
        grouped["gid"] = ids[None, None, :, None].expand(
            gr.shape).masked_select(gr)
        seg_len = gr.sum((2, 3)).flatten()  # (group, bucket) order
        for name, col in _sort_segments(seg_len, grouped).items():
            parts[name].append(col)

    def flat(name, dtype):
        if not parts[name]:
            return None
        return torch.cat(parts[name] + [torch.zeros(SPARE, dtype=dtype,
                                                    device=dev)])

    return CompactPlanes(
        v0=flat("v0", torch.int32), v1=flat("v1", torch.int32),
        g0=flat("g0", torch.int32), g1=flat("g1", torch.int32),
        gid=flat("gid", torch.uint8), occ=occ[:n].to(torch.uint8),
        start=start, goff=goff.to(torch.int32),
        padsq=((w - occ[:n]) ** 2).sum(1, dtype=torch.int64).to(
            torch.int32), window_max=window_max)


def compact_of(p0: torch.Tensor,
               p1: Optional[torch.Tensor]) -> CompactPlanes:
    """``compact_planes(p0, p1)``, kept on ``p0`` and built again only
    when ``p1`` is another tensor, either was modified in place, or the
    kept form has another ``LAYOUT``."""
    kept = getattr(p0, "_rtc_compact", None)
    if kept is not None and kept[0][0] is p1 and kept[0][1:] == _key(p0, p1):
        return kept[1]
    return keep_compact(p0, p1, compact_planes(p0, p1))


def keep_compact(p0: torch.Tensor, p1: Optional[torch.Tensor],
                 form: CompactPlanes) -> CompactPlanes:
    """Record ``form`` as the compact form of ``(p0, p1)``, for
    ``compact_of`` to return (a form copied with its planes to another
    device, in place of building it again there)."""
    p0._rtc_compact = ((p1, *_key(p0, p1)), form)
    return form


def _key(p0: torch.Tensor, p1: Optional[torch.Tensor]) -> tuple:
    """What a kept form must match besides ``p1`` itself: the layout and
    the planes' versions."""
    return LAYOUT, p0._version, None if p1 is None else p1._version


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        # one pinned host-to-device copy; the caching host allocator keeps
        # the pinned buffer alive until the copy has run
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def planes_to_device(packed: PackedSketches,
                     device: torch.device) -> DevicePlanes:
    """Planes as int32 views (no copy of values: equality is bitwise, so
    the ``0x80000000 | gid`` pad rule stays exact), sizes as int32."""
    return DevicePlanes(
        plane0=_to_device(packed.plane0.view(np.int32), device),
        plane1=None if packed.plane1 is None else
        _to_device(packed.plane1.view(np.int32), device),
        sizes=_to_device(packed.sizes.astype(np.int32), device))
