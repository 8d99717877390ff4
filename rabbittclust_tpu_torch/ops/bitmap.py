"""Bitmap candidate filter on the GPU (counterpart of the device half of
``rabbittclust_tpu/ops/bitmap.py``).

Each genome has a ``bits``-bit signature (a bit per mixed hash, packed by
the native ``pack_bitmaps_packed``).  For a pair the shared-bit
count popcount(x_i & x_j) bounds the exact common count from below
(``shared >= common - min(coll_i, coll_j)``), so the mask of this module
never drops a pair that can reach the threshold.

* K1 ``batched_mask`` — per-tile candidate counts and bit-packed masks for
  a batch of (rb x rb) tiles of the resident signatures; replaces the
  jitted ``_batched_mask_fn`` over ``_tile_mask``.  Kernel in
  ``csrc/filter_mask.cu``; ``batched_mask_plain`` is its plain torch
  version (unpack to 0/1, float32 product, the same float32 bound).
* K3 ``compact_masks_into`` — the set bits of K1's packed masks as
  ordered flat indices ``t * rb^2 + r * rb + c``, in one launch that takes
  K1's counts on the card (no host synchronisation) and reports the total
  on the card; ``compact_masks`` and ``compact_steps`` (a mesh ring's
  slab, each tile's bits ``r * rb + c``) pull that total once after it to
  size their result (``compact_sized``); with K1 in front,
  ``batched_filter`` returns what the jitted ``_batched_filter_fn`` over
  ``compact_mask_two_level`` returns.  Kernel in
  ``csrc/mask_compact.cu``; ``compact_masks_into_plain``,
  ``compact_masks_plain``, ``batched_filter_plain`` and
  ``compact_mask_two_level_plain`` are the plain torch versions.
* ``candidate_pair_blocks`` — the stream engine's batched generator: batch
  b+1's K1 is queued before batch b's pairs are decoded on the host.
  ``RTC_PULL_MODE`` picks the pull: ``mask`` and ``auto`` (the default)
  pull packed masks, ``idx`` queues K3 behind each K1 and pulls 4 bytes a
  candidate.
* ``candidate_pairs_threshold`` — every candidate with its exact common
  count (the DBSCAN neighbour lists and the leiden graph).

The wrappers run the plain versions only when the tensors lie on the CPU;
on a CUDA tensor they launch the kernel or raise.  ``LAUNCHES`` counts
kernel launches.  ``pack_mask_u8`` is shared with the dense engine.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..distance.mash import min_jaccard_for_threshold, size_ratio_limit
from ..utils import native as native_mod
from ..utils.profiling import span
from .intersect import _launch, _ptr, _upload
from .pack import _to_device
from .transfer import _host_async, _host_wait

LAUNCHES = {"filter_mask": 0, "mask_compact": 0}
# K3 launched again into a larger buffer after its total outgrew the first
# (counted in LAUNCHES too on the card; the plain versions count here only)
RELAUNCHES = {"mask_compact": 0}
BOUNDS = {"mst": 0, "greedy": 1, "minhash": 2}
# tiles per K1 launch of the stream generator (the JAX generator's default)
BATCH_TILES = 16
PULL_MODES = ("auto", "mask", "idx")
# K3's flat indices are int32, as the JAX program's are: a batch of k tiles
# of rb x rb needs k * rb^2 below this
INDEX_LIMIT = 1 << 31
# 32-bit words of a tile that one K3 block covers at least
# (``csrc/mask_compact.cu``: 4 KB in its narrow form, 16 KB in its wide
# one); a launch takes at most one status word of scratch a block of it
MASK_COMPACT_SEG = 1024
# the entries of K3's first output buffer on a device; later buffers follow
# the largest total seen there
K3_START_CAPACITY = 1 << 16
# K1's block of pairs (``csrc/filter_mask.cu`` BM = BN)
BLOCK = 128
# the ring step's tile of pairs, rows x columns (``csrc/ring_step.cu`` BM,
# BN)
RING_TILE = (128, 256)

# the (3, 1) int32 tile geometry [0], [0], [1] (one valid tile at the
# origin) on each device, uploaded once
_GEOMETRY: dict = {}
# K3's scratch on each (device, stream) (``K3Scratch``)
_K3_SCRATCH: dict = {}
# K3's output capacity on each device (``k3_buffer``): the largest total
# seen there
_K3_CAPACITY: dict = {}

# device-to-host bytes and pulls of the filter (reset_pull_stats() zeroes)
PULL_STATS = {"bytes": 0, "pulls": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    RELAUNCHES["mask_compact"] = 0


def reset_pull_stats() -> None:
    PULL_STATS["bytes"] = 0
    PULL_STATS["pulls"] = 0


def account_pull(n_bytes: int) -> None:
    PULL_STATS["bytes"] += int(n_bytes)
    PULL_STATS["pulls"] += 1


# Source: rabbittclust_tpu/ops/bitmap.py::pack_bitmaps_packed
def pack_bitmaps_packed(hashes: List[np.ndarray], bits: int = 8192,
                        pad_n_to: int = 128
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Bit-packed signatures: (uint8 (N_pad, bits//8), collisions int32),
    packed by the native library; bit b of genome i is set when a hash h of
    it has (h * 0x9E3779B97F4A7C15 mod 2^64) >> (64 - log2 bits) == b, in
    np.packbits(bitorder='little') order."""
    n = len(hashes)
    n_pad = max(((n + pad_n_to - 1) // pad_n_to) * pad_n_to, pad_n_to)
    out = np.zeros((n_pad, bits // 8), dtype=np.uint8)
    coll = np.zeros(n_pad, dtype=np.int32)
    if n == 0:
        return out, coll
    lib = native_mod.load_native()
    use64 = hashes[0].dtype == np.uint64
    flat, offs = native_mod.flatten_csr(hashes, use64)
    fn = lib.rtc_pack_bitmaps_u64 if use64 else lib.rtc_pack_bitmaps_u32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int]
    fn(flat.ctypes.data, offs.ctypes.data, n, bits, out.ctypes.data,
       coll.ctypes.data, os.cpu_count() or 1)
    return out, coll


# Source: rabbittclust_tpu/ops/bitmap.py::_decode_packed_mask
def _decode_packed_mask(packed: np.ndarray, rb: int, r0: int, c0: int,
                        n: int, expect: int):
    """Global (ii, jj) int64 pairs from one pulled packed-mask tile, by the
    native popcount/ctz bit-scan (~GB/s); rows at or past ``n`` (padding)
    are skipped."""
    lib = native_mod.load_native()
    if not hasattr(lib, "_rtc_mask_pairs_sig"):
        lib.rtc_mask_pairs.restype = ctypes.c_int64
        lib.rtc_mask_pairs.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib._rtc_mask_pairs_sig = True
    ii = np.empty(expect, dtype=np.int64)
    jj = np.empty(expect, dtype=np.int64)
    got = lib.rtc_mask_pairs(
        packed.ctypes.data, rb, packed.shape[1], r0, c0, n,
        ii.ctypes.data, jj.ctypes.data, os.cpu_count() or 1)
    assert got == expect, (got, expect)  # device count is exact
    return ii, jj


# Source: rabbittclust_tpu/ops/bitmap.py::CsrSketches
class CsrSketches:
    """Flattened CSR view of a sketch list, built once and reused across
    exact-verification calls."""

    def __init__(self, hashes: List[np.ndarray]):
        self.n = len(hashes)
        self.use64 = self.n > 0 and hashes[0].dtype == np.uint64
        # parallel native gather (rtc_flatten)
        self.flat, self.offs = native_mod.flatten_csr(hashes, self.use64)

    def count_common(self, ii: np.ndarray, jj: np.ndarray,
                     threads: int = 0) -> np.ndarray:
        out = np.zeros(len(ii), dtype=np.int32)
        if len(ii) == 0:
            return out
        lib = native_mod.load_native()
        fn = (lib.rtc_count_common_u64 if self.use64
              else lib.rtc_count_common_u32)
        ii32 = np.ascontiguousarray(ii, dtype=np.int32)
        jj32 = np.ascontiguousarray(jj, dtype=np.int32)
        fn(self.flat.ctypes.data, self.offs.ctypes.data, ii32.ctypes.data,
           jj32.ctypes.data, len(ii), out.ctypes.data,
           threads or (os.cpu_count() or 1))
        return out


def pack_mask_u8(mask: torch.Tensor) -> torch.Tensor:
    """Bit-pack a boolean (..., r, c) mask to (..., r, c // 8) uint8,
    little bit order (the inverse of ``np.unpackbits(bitorder="little")``);
    byte-equal to the JAX version."""
    *lead, c = mask.shape
    bits = mask.reshape(*lead, c // 8, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=mask.device)
    return (bits * weights).sum(-1, dtype=torch.int32).to(torch.uint8)


def unpack_bits(xp: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, B // 8) uint8 -> (N, B) 0/1 of ``dtype``, little bit order."""
    shifts = torch.arange(8, dtype=torch.uint8, device=xp.device)
    bits = (xp[:, :, None] >> shifts) & 1
    return bits.reshape(xp.shape[0], -1).to(dtype)


def filter_scalars(threshold: float, kmer_size: int, bound: str = "mst"):
    """(jmin_num, jmin_den, c_min, radio) as the JAX generator passes them:
    float32 scalars, ``radio`` int32 for "mst" and float32 otherwise
    ("minhash" carries j_min in the ``c_min`` slot)."""
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    if bound == "minhash":
        c_min, radio = j_min, np.float32(0.0)
    elif bound == "greedy":
        radio = np.float32(2.0 * math.exp(threshold * kmer_size) - 1.0)
    else:
        radio = np.int32(size_ratio_limit(threshold, kmer_size - 1))
    return np.float32(j_min), np.float32(1.0 + j_min), np.float32(c_min), \
        radio


def tile_mask_plain(xd, cd, sd, r0, c0, rb, jmin_num, jmin_den, c_min,
                    radio, is_containment, bound="mst", cols=None,
                    tri=True) -> torch.Tensor:
    """Safe candidate mask (rb, rb) bool of the tile rows [r0, +rb) x
    columns [c0, +rb); the operations of ``_tile_mask``, in its order.
    The float32 product of 0/1 values is exact (counts < 2^24).  ``cols``,
    when given, is the (signatures, collisions, sizes) the columns come
    from (a visiting shard's); ``tri`` keeps column < row only.  Under the
    "mst" bound ``radio`` 0 disables the size-ratio gate (as in the JAX
    mesh rings; the sweep's radio is never 0)."""
    dev = xd.device
    f32 = torch.float32
    xc, cc, sc = (xd, cd, sd) if cols is None else cols
    xi = unpack_bits(xd[r0:r0 + rb])
    xj = unpack_bits(xc[c0:c0 + rb])
    ci, cj = cd[r0:r0 + rb], cc[c0:c0 + rb]
    if bound == "minhash":
        si, sj = sd[0, r0:r0 + rb], sc[1, c0:c0 + rb]
    else:
        si, sj = sd[r0:r0 + rb], sc[c0:c0 + rb]
    shared = (xi @ xj.T).to(torch.int32)
    si_c = si[:, None].to(f32)
    s_c = sj[None, :].to(f32)
    num, den, cm = (torch.tensor(float(v), dtype=f32, device=dev)
                    for v in (jmin_num, jmin_den, c_min))
    if is_containment:
        common_min = torch.floor(cm * torch.minimum(si_c, s_c)).to(
            torch.int32) - 1
    else:
        common_min = torch.floor(num * (si_c + s_c) / den).to(
            torch.int32) - 1
    thresh = common_min - torch.minimum(ci[:, None], cj[None, :])
    mni = torch.minimum(si[:, None], sj[None, :])
    if bound == "minhash" or (bound == "greedy" and is_containment):
        ratio_ok = mni > 0
    elif bound == "greedy":
        rf = torch.tensor(float(radio), dtype=f32, device=dev)
        ratio_ok = (mni > 0) & (torch.maximum(si_c, s_c)
                                <= rf * torch.minimum(si_c, s_c) + 1.0)
    else:
        mxi = torch.maximum(si[:, None], sj[None, :])
        ratio_ok = (mni > 0) & ((mxi <= int(radio) * mni) if int(radio)
                                else True)
    mask = (shared >= thresh) & ratio_ok
    if tri:
        iota = torch.arange(rb, dtype=torch.int32, device=dev)
        mask &= (iota[None, :] + c0) < (iota[:, None] + r0)
    return mask


def batched_mask_plain(xd, cd, sd, r0s, c0s, valid, jmin_num, jmin_den,
                       c_min, radio, is_containment, rb, bound="mst"):
    """Plain K1: per-tile counts (k,) int32 and packed masks
    (k, rb, rb // 8) uint8; tiles with ``valid == 0`` give 0 and zeros."""
    k = len(r0s)
    counts = torch.zeros(k, dtype=torch.int32, device=xd.device)
    packs = torch.zeros((k, rb, rb // 8), dtype=torch.uint8,
                        device=xd.device)
    for t, (r0, c0, ok) in enumerate(zip(r0s, c0s, valid)):
        if ok:
            m = tile_mask_plain(xd, cd, sd, int(r0), int(c0), rb, jmin_num,
                                jmin_den, c_min, radio, is_containment,
                                bound)
            counts[t] = m.sum(dtype=torch.int32)
            packs[t] = pack_mask_u8(m)
    return counts, packs


def _check_signatures(xd, cd, sd, bound, dev):
    """The (signatures, collisions, sizes) of one side of K1 on ``dev``."""
    if (xd.dtype != torch.uint8 or xd.dim() != 2 or not xd.is_contiguous()
            or xd.shape[1] % 8 or xd.shape[1] == 0 or xd.device != dev):
        raise ValueError(f"signatures must be a contiguous (n_pad, bits // 8)"
                         f" uint8 tensor on {dev} with whole 64-bit words")
    n_pad = xd.shape[0]
    want_sd = (2, n_pad) if bound == "minhash" else (n_pad,)
    for name, t, shape in (("collisions", cd, (n_pad,)),
                           ("sizes", sd, want_sd)):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on {dev}")


def _check_filter_inputs(xd, cd, sd, bound, rb, r0s, c0s, valid):
    if xd.device.type != "cuda":
        raise ValueError(f"signatures on {xd.device}: expected cuda or cpu")
    _check_signatures(xd, cd, sd, bound, xd.device)
    if rb <= 0 or rb % 32:
        raise ValueError(f"rb={rb}: must be a positive multiple of 32")
    live = valid != 0
    if live.any() and (min(r0s[live].min(), c0s[live].min()) < 0 or
                       max(r0s[live].max(), c0s[live].max()) + rb
                       > xd.shape[0]):
        raise ValueError(f"a tile of {rb} rows leaves the {xd.shape[0]} "
                         "padded signatures")


def tri_count(nbx: int, nby: int) -> int:
    """Blocks of a tile of ``nby`` x ``nbx`` blocks of 128² pairs that
    ``tri_block`` enumerates: those with bx <= by."""
    m = min(nbx, nby)
    return m * (m + 1) // 2 + (nby - m) * nbx


def tri_block(k: int, nbx: int, nby: int) -> Tuple[int, int]:
    """(by, bx) of the k-th block with bx <= by, row by row: the map K1's
    triangular grid applies to its 1-D block index (``csrc/filter_mask.cu
    ::tri_block``); the first min(nbx, nby) rows hold by + 1 blocks, later
    rows all nbx."""
    m = min(nbx, nby)
    head = m * (m + 1) // 2
    if k < head:
        y = (math.isqrt(8 * k + 1) - 1) // 2
        return y, k - y * (y + 1) // 2
    return m + (k - head) // nbx, (k - head) % nbx


def ring_row_tiles(by: int, rows: int, cols: int, tri: bool) -> int:
    """Tiles of row block ``by`` that the ring step's kernel visits
    (``csrc/ring_step.cu::ring_row_tiles``): every column block, or on a
    self step (``tri``) those starting below the block's last row."""
    bm_, bn = RING_TILE
    nbx = -(-cols // bn)
    if not tri:
        return nbx
    i_max = min(by * bm_ + bm_, rows) - 1
    return 0 if i_max < 1 else min(nbx, (i_max - 1) // bn + 1)


def ring_tiles(rows: int, cols: int, tri: bool) -> List[Tuple[int, int]]:
    """(by, bx) of every tile the ring step's kernel visits, in its walk's
    order (row by row)."""
    nby = -(-rows // RING_TILE[0])
    return [(by, bx) for by in range(nby)
            for bx in range(ring_row_tiles(by, rows, cols, tri))]


def ring_cta_tiles(rows: int, cols: int, tri: bool, grid: int,
                   cta: int) -> List[Tuple[int, int]]:
    """The tiles CTA ``cta`` of the kernel's persistent grid of ``grid``
    visits, by the kernel's own walk (``csrc/ring_step.cu
    ::ring_tile_next``: from (0, 0) advance ``cta`` tiles, then ``grid`` a
    tile); ``ring_tiles(...)[cta::grid]``."""
    nby = -(-rows // RING_TILE[0])
    n_tiles = sum(ring_row_tiles(by, rows, cols, tri) for by in range(nby))
    out, by, bx = [], 0, 0

    def advance(step, by, bx):
        bx += step
        while by < nby:
            n = ring_row_tiles(by, rows, cols, tri)
            if bx < n:
                break
            bx -= n
            by += 1
        return by, bx

    by, bx = advance(cta, by, bx)
    for _ in range(cta, n_tiles, grid):
        out.append((by, bx))
        by, bx = advance(grid, by, bx)
    return out


def tile_geometry(device: torch.device) -> torch.Tensor:
    """The (3, 1) int32 geometry of one valid tile at the origin on
    ``device`` (K1's r0s, c0s, valid), uploaded at the first call a
    device."""
    geo = _GEOMETRY.get(device)
    if geo is None:
        geo = _GEOMETRY[device] = _upload(np.array([[0], [0], [1]]), device)
    return geo


def launch_filter(rows, cols, gather, geo, k, n_rows, n_cols, row_words,
                  scalars, is_containment, bound, tri, counts, packs) -> None:
    """One K1 launch (``csrc/filter_mask.cu::rtc_filter_mask``), counted
    by the caller: ``rows``
    and ``cols`` are (signatures, collisions, sizes) of each side (sizes
    (2, n) under "minhash": the rows read row 0, the columns row 1);
    ``gather`` None or the (row, column) int32 genome of each position
    (K6); ``geo`` (3, k) int32 tile origins and validity on the card;
    ``tri`` 0 or False, 1 or True."""
    from ..kernels._build import load_kernels
    lib = load_kernels()
    (xr, cr, sr), (xc, cc, sc) = rows, cols
    if bound == "minhash":
        sr, sc = sr[0], sc[1]
    jmin_num, jmin_den, c_min, radio = scalars
    radio_i = int(radio) if bound == "mst" else 0
    radio_f = float(radio) if bound == "greedy" else 0.0
    gr, gc = (None, None) if gather is None else gather
    dev = xr.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.rtc_filter_mask, xr.data_ptr(), xc.data_ptr(),
                xr.shape[1] // 8, cr.data_ptr(), cc.data_ptr(),
                sr.data_ptr(), sc.data_ptr(), _ptr(gr), _ptr(gc),
                geo[0].data_ptr(), geo[1].data_ptr(), geo[2].data_ptr(), k,
                n_rows, n_cols, row_words, ctypes.c_float(float(jmin_num)),
                ctypes.c_float(float(jmin_den)),
                ctypes.c_float(float(c_min)), radio_i,
                ctypes.c_float(radio_f), int(bool(is_containment)),
                BOUNDS[bound], int(tri), counts.data_ptr(),
                packs.data_ptr(), stream)


def launch_ring_step(rows, cols, scalars, is_containment, tri, count,
                     packs) -> None:
    """One launch of the ring step's kernel (``csrc/ring_step.cu
    ::rtc_ring_step``), counted by the caller: ``rows`` and ``cols`` are
    (signatures, collisions, sizes) of the local and the visiting shard,
    ``scalars`` (jmin_num, jmin_den, c_min, radio) of the "mst" bound
    (radio 0: no ratio gate), ``tri`` the self step's triangle; ``count``
    (1,) int32 is added to, ``packs`` (rows, cols / 8) uint8 written on
    the tiles visited."""
    from ..kernels._build import load_kernels
    lib = load_kernels()
    (xr, cr, sr), (xc, cc, sc) = rows, cols
    jmin_num, jmin_den, c_min, radio = scalars
    dev = xr.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.rtc_ring_step, xr.data_ptr(), xc.data_ptr(),
                xr.shape[1] // 8, cr.data_ptr(), cc.data_ptr(),
                sr.data_ptr(), sc.data_ptr(), xr.shape[0], xc.shape[0],
                xc.shape[0] // 32, ctypes.c_float(float(jmin_num)),
                ctypes.c_float(float(jmin_den)),
                ctypes.c_float(float(c_min)), int(radio),
                int(bool(is_containment)), int(bool(tri)), count.data_ptr(),
                packs.data_ptr(), stream)


def batched_mask(xd, cd, sd, r0s, c0s, valid, jmin_num, jmin_den, c_min,
                 radio, is_containment, rb, bound="mst"):
    """K1: ``batched_mask_plain``'s result.  ``r0s``, ``c0s`` and ``valid``
    are host int sequences of one length; the other arguments are those of
    the JAX ``_batched_mask_fn`` (``sd`` is (2, n_pad) for "minhash")."""
    if bound not in BOUNDS:
        raise ValueError(f"unknown bound {bound!r}")
    r0s, c0s, valid = (np.asarray(x, dtype=np.int64).reshape(-1)
                       for x in (r0s, c0s, valid))
    if not len(r0s) == len(c0s) == len(valid):
        raise ValueError("r0s, c0s and valid differ in length")
    if xd.device.type == "cpu":
        return batched_mask_plain(xd, cd, sd, r0s, c0s, valid, jmin_num,
                                  jmin_den, c_min, radio, is_containment,
                                  rb, bound)
    _check_filter_inputs(xd, cd, sd, bound, rb, r0s, c0s, valid)
    k = len(r0s)
    dev = xd.device
    idx = _upload(np.stack([r0s, c0s, valid != 0]), dev)
    counts = torch.zeros(k, dtype=torch.int32, device=dev)
    packs = torch.empty((k, rb, rb // 8), dtype=torch.uint8, device=dev)
    launch_filter((xd, cd, sd), (xd, cd, sd), None, idx, k, rb, rb, rb // 32,
                  (jmin_num, jmin_den, c_min, radio), is_containment, bound,
                  True, counts, packs)
    LAUNCHES["filter_mask"] += 1
    return counts, packs


def _nonzero_sized(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(x, size=size, fill_value=-1)`` of a 1-D mask: the
    first ``size`` indices of its set entries, ascending, -1 padded (int32)."""
    (idx,) = torch.nonzero(x, as_tuple=True)
    out = torch.full((size,), -1, dtype=torch.int32, device=x.device)
    k = min(size, idx.numel())
    out[:k] = idx[:k].to(torch.int32)
    return out


# Source: rabbittclust_tpu/ops/bitmap.py::compact_mask_two_level
def compact_mask_two_level_plain(mask: torch.Tensor, cap_tile: int,
                                 cap_chunks: int):
    """(count int32, flat indices (cap_tile,) int32, -1 padded) of a 2-D
    bool mask, by the JAX program's two levels: the W-wide column chunks
    with a set entry (W = min(512, ncols)), then the entries of those
    chunks.  Exact while the hit chunks fit ``cap_chunks`` and the set
    entries ``cap_tile``; the flat branch when the columns do not divide
    by W or ``cap_chunks`` covers the whole chunk grid."""
    nrows, ncols = mask.shape
    count = mask.sum(dtype=torch.int32)
    w = min(512, ncols)
    if ncols % w or cap_chunks >= nrows * (ncols // w):
        return count, _nonzero_sized(mask.reshape(-1), cap_tile)
    ncc = ncols // w
    m3 = mask.reshape(nrows, ncc, w)
    cid = _nonzero_sized(m3.any(dim=2).reshape(-1), cap_chunks)
    okc = cid >= 0
    rows = cid.clamp(min=0) // ncc
    cols = cid.clamp(min=0) % ncc
    sub = m3[rows.long(), cols.long()] & okc[:, None]
    loc = _nonzero_sized(sub.reshape(-1), cap_tile)
    c2 = (loc.clamp(min=0) // w).long()
    flat = rows[c2] * ncols + cols[c2] * w + loc.clamp(min=0) % w
    return count, torch.where(loc >= 0, flat, -1).to(torch.int32)


# Source: rabbittclust_tpu/ops/bitmap.py::_batched_filter_fn
def batched_filter_plain(xd, cd, sd, ts, r0s, c0s, valid, jmin_num,
                         jmin_den, c_min, radio, is_containment, cap_tile,
                         cap_chunks, rb, bound="mst") -> torch.Tensor:
    """Plain K1 + K3 for a batch: one int32 tensor [total, max tile
    count, buffer (k * cap_tile)].  Tile t's mask is compacted and its
    indices, encoded ``ts[t] * rb^2 + local``, are written at the running
    total over ``cap_tile`` slots (the compaction's padding, encoded too,
    is overwritten by the next tile's write or lies past the final
    total), as the JAX scan writes them; invalid tiles write -1."""
    k = len(ts)
    dev = xd.device
    buf = torch.full((k * cap_tile,), -1, dtype=torch.int32, device=dev)
    total = maxc = 0
    for t in range(k):
        if valid[t]:
            mask = tile_mask_plain(xd, cd, sd, int(r0s[t]), int(c0s[t]), rb,
                                   jmin_num, jmin_den, c_min, radio,
                                   is_containment, bound)
            count, flat = compact_mask_two_level_plain(mask, cap_tile,
                                                       cap_chunks)
            # int32 arithmetic, wrapping as the JAX program's does
            enc = (flat.long() + int(ts[t]) * rb * rb).to(torch.int32)
            count = int(count)
        else:
            enc = torch.full((cap_tile,), -1, dtype=torch.int32, device=dev)
            count = 0
        # dynamic_update_slice clamps the start so that the update fits
        start = min(total, k * cap_tile - cap_tile)
        buf[start:start + cap_tile] = enc
        total += count
        maxc = max(maxc, count)
    head = torch.tensor([total, maxc], dtype=torch.int32, device=dev)
    return torch.cat([head, buf])


def compact_masks_plain(packs: torch.Tensor, sel) -> torch.Tensor:
    """Plain K3: the set bits of tiles ``sel`` of ``packs`` (k, rb, rb // 8)
    uint8, as int32 ``p * rb^2 + r * rb + c`` (p the tile's place in
    ``sel``), in order: tile by tile, row-major within a tile."""
    rb = packs.shape[1]
    sel_t = torch.as_tensor(list(sel), dtype=torch.long, device=packs.device)
    bits = unpack_bits(packs.index_select(0, sel_t).reshape(-1, rb // 8),
                       torch.bool)
    (flat,) = torch.nonzero(bits.reshape(-1), as_tuple=True)
    return flat.to(torch.int32)


def _wrap32(x: int) -> int:
    """``x`` as int32 arithmetic leaves it (the JAX program's wrap)."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def compact_masks_into_plain(packs, counts, out, limit, codes="slots",
                             sel=None, head=None, pad=None) -> torch.Tensor:
    """Plain ``compact_masks_into``, on the same contract: the tiles whose
    count is 0 are not read, no write reaches ``out[limit:]``, and the head
    reports the total of the counts, also past ``limit``."""
    k, rb = packs.shape[0], packs.shape[1]
    sel = list(range(k)) if sel is None else [int(t) for t in sel]
    cnt = [int(c) for c in torch.as_tensor(counts).reshape(-1).tolist()]
    parts = []
    for q, t in enumerate(sel):
        if not cnt[t]:
            continue
        if isinstance(codes, str):
            code = q if codes == "slots" else 0
        else:
            code = int(codes[q])
        flat = compact_masks_plain(packs, [t]).to(torch.int64)
        parts.append(((flat + _wrap32(code * rb * rb) + (1 << 31))
                      % (1 << 32) - (1 << 31)).to(torch.int32))
    enc = torch.cat(parts) if parts else torch.empty(0, dtype=torch.int32)
    total = sum(cnt[t] for t in sel)
    n = min(len(enc), limit)
    out[:n] = enc[:n].to(out.device)
    if pad is not None and sel:
        cap, value = pad
        end = min(total - cnt[sel[-1]] + cap, limit)
        if end > total:
            out[total:end] = _wrap32(value)
    vals = [total, max((cnt[t] for t in sel), default=0)]
    if head is None:
        head = torch.empty(1, dtype=torch.int32, device=out.device)
    head[:] = torch.tensor(vals[:head.numel()], dtype=torch.int32)
    return head


def _check_index_range(k: int, rb: int) -> None:
    if k * rb * rb >= INDEX_LIMIT:
        raise ValueError(
            f"{k} tiles of {rb} x {rb} pairs: flat pair indices t * rb^2 + "
            f"local reach {k * rb * rb}, past int32 (the JAX program's "
            "indices wrap there); use fewer or smaller tiles")


class K3Scratch:
    """K3's scratch on one stream of a device (``csrc/mask_compact.cu``):
    int64 words, the ticket word then a status word a block, zeroed once,
    and the host's count of the launches on it (the epoch).  Nothing is
    cleared between launches: the ticket word goes back to 0 with a
    launch's last ticket, and a status word of another launch's epoch
    counts as unpublished."""

    def __init__(self, device: torch.device, n_blocks: int):
        self.words = torch.zeros(1 + max(n_blocks, 1 << 14),
                                 dtype=torch.int64, device=device)
        self.epoch = 0

    @property
    def blocks(self) -> int:
        return self.words.numel() - 1

    def launch(self):
        """(pointer, status words, epoch) for the next launch."""
        self.epoch = self.epoch % ((1 << 30) - 1) + 1
        return self.words.data_ptr(), self.blocks, ctypes.c_uint(self.epoch)


def k3_scratch(device: torch.device, n_blocks: int) -> K3Scratch:
    """K3's scratch for a launch of ``n_blocks`` blocks on ``device``'s
    current stream, allocated (zeroed) at the first launch there and
    again, larger, when a launch needs more blocks.  One a stream: the
    ticket word and the epoch hold only for launches in one stream's
    order."""
    key = _stream_key(device)
    s = _K3_SCRATCH.get(key)
    if s is None or s.blocks < n_blocks:
        s = _K3_SCRATCH[key] = K3Scratch(device, n_blocks)
    return s


def launch_k3(fn, device: torch.device, n_blocks: int, *args) -> None:
    """Call the C entry ``fn`` with ``args``, the scratch's pointer, status
    words and epoch where ``args`` holds ``None``.  A launch that fails
    may leave the ticket word set: the scratch goes, and the next launch
    allocates it afresh."""
    scratch = k3_scratch(device, n_blocks)
    i = args.index(None)
    try:
        _launch(fn, *args[:i], *scratch.launch(), *args[i + 1:])
    except RuntimeError:
        _K3_SCRATCH.pop(_stream_key(device), None)
        raise


def _stream_key(device: torch.device):
    return device, torch.cuda.current_stream(device).cuda_stream


def _counts_on(packs: torch.Tensor, counts) -> torch.Tensor:
    """``counts`` as an int32 tensor on ``packs``' device (a host sequence
    is uploaded)."""
    if isinstance(counts, torch.Tensor):
        return counts.reshape(-1)
    return _upload(np.asarray(counts, dtype=np.int64).reshape(-1),
                   packs.device)


def compact_masks_into(packs: torch.Tensor, counts: torch.Tensor,
                       out: torch.Tensor, limit: int, codes="slots",
                       sel=None, head: Optional[torch.Tensor] = None,
                       pad=None) -> torch.Tensor:
    """K3 (``csrc/mask_compact.cu``), one launch, no host synchronisation:
    the set bits of tiles ``sel`` (host indices into ``packs``, in output
    order; default every tile) of ``packs`` (k, rb, rb // 8) uint8, tile
    after tile and row-major within a tile, into ``out`` (int32); no write
    reaches ``out[limit:]``.  ``counts``: K1's exact per-tile counts, int32
    on the same device; a tile starts at the sum of the counts of the
    tiles before it, and a tile with none is not read.  A tile's bits are
    encoded ``code * rb^2 + r * rb + c`` with code its place in ``sel``
    (``codes="slots"``), 0 (``"local"``) or ``codes[place]`` (host ints).
    ``head``, when given, an int32 tensor of 1 or 2 entries, receives [the
    total] or [the total, the largest count]; ``pad`` = (cap, value)
    writes value from the total on to the last tile's start + cap (the
    padding of ``batched_filter``'s buffer).  Returns the head (a new (1,)
    tensor when none is given): the total counts every set bit, also
    those past ``limit``."""
    k, rb = packs.shape[0], packs.shape[1]
    if not 0 <= limit <= out.numel():
        raise ValueError(f"limit {limit} outside out's {out.numel()} entries")
    counts = _counts_on(packs, counts)
    if packs.device.type == "cpu":
        return compact_masks_into_plain(packs, counts, out, limit, codes, sel,
                                        head, pad)
    if packs.device.type != "cuda":
        raise ValueError(f"packs on {packs.device}: expected cuda or cpu")
    if (packs.dtype != torch.uint8 or not packs.is_contiguous()
            or tuple(packs.shape) != (k, rb, rb // 8) or rb % 32
            or packs.data_ptr() % 16):
        raise ValueError("packs must be a contiguous, 16-byte aligned "
                         "(k, rb, rb // 8) uint8 tensor, rb a multiple of 32")
    dev = packs.device
    for name, t in (("out", out), ("counts", counts), ("head", head)):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()
                              or t.device != dev):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}")
    if counts.numel() < k:
        raise ValueError(f"{counts.numel()} counts for {k} tiles")
    m = k if sel is None else len(sel)
    if head is None:
        head = torch.empty(1, dtype=torch.int32, device=dev)
    elif head.numel() not in (1, 2):
        raise ValueError("head takes [total] or [total, largest count]")
    if m == 0:
        head.zero_()
        return head
    src = None
    if sel is not None:
        sel = np.asarray(sel, dtype=np.int64).reshape(-1)
        if sel.min() < 0 or sel.max() >= k:
            raise ValueError(f"sel outside the {k} tiles")
        src = _upload(sel, dev)
    local = isinstance(codes, str) and codes == "local"
    code_t = None
    if not isinstance(codes, str):
        code_t = _upload(np.asarray(codes, dtype=np.int64).reshape(-1), dev)
        if code_t.numel() != m:
            raise ValueError(f"{code_t.numel()} codes for {m} tiles")
    elif codes not in ("slots", "local"):
        raise ValueError(f"codes={codes!r}: 'slots', 'local' or host ints")
    pad_cap, pad_value = (0, 0) if pad is None else (int(pad[0]),
                                                     _wrap32(pad[1]))
    from ..kernels._build import load_kernels
    lib = load_kernels()
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch_k3(lib.rtc_mask_compact, dev,
                  m * -(-rb * rb // 32 // MASK_COMPACT_SEG),
                  packs.data_ptr(), _ptr(src), counts.data_ptr(),
                  _ptr(code_t), m, rb, int(local), limit, out.data_ptr(),
                  head.data_ptr(), head.numel(), pad_cap, pad_value, None,
                  stream)
    LAUNCHES["mask_compact"] += 1
    return head


def _on(dev: torch.device):
    """``torch.cuda.device(dev)``, or nothing when ``dev`` is current
    already (the context costs the non-syncing call host time)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def k3_buffer(dev: torch.device,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An int32 buffer for K3 on ``dev`` of the capacity seen there so far
    (``K3_START_CAPACITY``, then the largest total ``k3_complete`` saw):
    ``out`` when it holds as many entries, else a new one."""
    cap = _K3_CAPACITY.get(dev, K3_START_CAPACITY)
    if out is None or out.numel() < cap:
        out = torch.empty(cap, dtype=torch.int32, device=dev)
    return out


def k3_complete(packs: torch.Tensor, counts: torch.Tensor,
                out: torch.Tensor, total: int, **kw) -> torch.Tensor:
    """After ``compact_masks_into(packs, counts, out, out.numel(), **kw)``,
    with its ``total`` on the host: ``out`` when it held every index, else
    K3 launched again (``RELAUNCHES``) into a new buffer of ``total``
    entries, the device's capacity from then on.  Returns the buffer that
    holds the ``total`` indices."""
    if total <= out.numel():
        return out
    dev = packs.device
    _K3_CAPACITY[dev] = max(total, _K3_CAPACITY.get(dev, 0))
    out = torch.empty(total, dtype=torch.int32, device=dev)
    compact_masks_into(packs, counts, out, total, **kw)
    RELAUNCHES["mask_compact"] += 1
    return out


def compact_sized(packs: torch.Tensor, counts: torch.Tensor, **kw):
    """``compact_masks_into`` into a ``k3_buffer``, then one pull of the
    total (``k3_complete`` launches K3 again when it outgrew the buffer).
    Returns the int32 (total,) output on the card."""
    out = k3_buffer(packs.device)
    total = int(compact_masks_into(packs, counts, out, out.numel(), **kw)[0])
    return k3_complete(packs, counts, out, total, **kw)[:total]


def _check_flat_range(rows: int, cols: int) -> None:
    if rows * cols >= INDEX_LIMIT:
        raise ValueError(
            f"a {rows} x {cols} mask: flat pair indices r * {cols} + c reach "
            f"{rows * cols}, past int32 (the JAX program's indices wrap "
            "there); use fewer rows or columns")


def compact_masks(packs: torch.Tensor, counts, sel) -> torch.Tensor:
    """K3: ``compact_masks_plain``'s result, int32 (total,).  ``counts`` are
    K1's exact per-tile counts on the card (a host sequence is uploaded),
    ``sel`` host tile indices in output order.  One launch, then one pull
    of its total (``compact_sized``)."""
    sel = [int(t) for t in sel]
    _check_index_range(packs.shape[0], packs.shape[1])
    if packs.device.type == "cpu":
        return compact_masks_plain(packs, sel)
    if packs.device.type != "cuda":
        raise ValueError(f"packs on {packs.device}: expected cuda or cpu")
    if not sel:
        return torch.empty(0, dtype=torch.int32, device=packs.device)
    return compact_sized(packs, _counts_on(packs, counts), sel=sel)


def compact_steps(packs: torch.Tensor, counts) -> torch.Tensor:
    """K3 over every tile of ``packs`` (k, rb, rb // 8) uint8 (a mesh
    ring's slab of steps) in one launch: the set bits of each tile as its
    local position ``r * rb + c`` (int32), tile after tile, row-major
    within a tile.  ``counts``: the exact per-tile counts, on the card
    (a host sequence is uploaded); tiles with none are not read."""
    k, rb = packs.shape[0], packs.shape[1]
    counts = _counts_on(packs, counts)
    if counts.numel() != k:
        raise ValueError(f"{counts.numel()} counts for {k} tiles")
    _check_index_range(1, rb)
    if packs.device.type == "cpu":
        parts = [compact_masks_plain(packs, [t])
                 for t in np.flatnonzero(counts.numpy())]
        return torch.cat(parts) if parts else \
            torch.empty(0, dtype=torch.int32)
    if packs.device.type != "cuda":
        raise ValueError(f"packs on {packs.device}: expected cuda or cpu")
    return compact_sized(packs, counts, codes="local")


def batched_filter(xd, cd, sd, ts, r0s, c0s, valid, jmin_num, jmin_den,
                   c_min, radio, is_containment, cap_tile, cap_chunks, rb,
                   bound="mst") -> torch.Tensor:
    """K1 then K3: ``batched_filter_plain``'s result, whole buffer.  The
    arguments are those of the JAX ``_batched_filter_fn``; ``ts``, ``r0s``,
    ``c0s`` and ``valid`` are host int sequences.  On the card K3 takes
    K1's counts where K1 wrote them and writes the head [total, largest
    count] and the last tile's encoded padding itself; one pull of the
    head follows.  ``cap_tile`` must hold every tile's count and
    ``cap_chunks`` every tile's hit chunks (the count, or the whole chunk
    grid), the sizing under which the JAX program loses no index: past
    it, the pull raises."""
    ts, r0s, c0s, valid = (np.asarray(x, dtype=np.int64).reshape(-1)
                           for x in (ts, r0s, c0s, valid))
    k = len(ts)
    _check_index_range(k, rb)
    if xd.device.type == "cpu":
        return batched_filter_plain(xd, cd, sd, ts, r0s, c0s, valid,
                                    jmin_num, jmin_den, c_min, radio,
                                    is_containment, cap_tile, cap_chunks, rb,
                                    bound)
    counts, packs = batched_mask(xd, cd, sd, r0s, c0s, valid, jmin_num,
                                 jmin_den, c_min, radio, is_containment, rb,
                                 bound)
    out = torch.full((2 + k * cap_tile,), -1, dtype=torch.int32,
                     device=xd.device)
    if k:
        pad = ((cap_tile, int(ts[-1]) * rb * rb - 1)
               if valid[-1] and cap_tile else None)
        compact_masks_into(packs, counts, out[2:], k * cap_tile,
                           codes=ts, head=out[:2], pad=pad)
    else:
        out[:2] = 0
    maxc = int(out[1])
    w = min(512, rb)
    grid = rb * (rb // w) if rb % w == 0 else 0
    if maxc > cap_tile or cap_chunks < min(maxc, grid):
        raise ValueError(f"cap_tile {cap_tile} / cap_chunks {cap_chunks} "
                         f"below the largest tile count {maxc}: the JAX "
                         "program would drop indices there")
    return out


@dataclass
class Signatures:
    """The filter's resident state: packed signatures (n_pad, bits // 8)
    uint8, collisions (n_pad,) int32 and sizes (n_pad,) int32, or
    (2, n_pad) row/column sizes for the "minhash" bound."""
    xd: torch.Tensor
    cd: torch.Tensor
    sd: torch.Tensor

    @property
    def n_pad(self) -> int:
        return self.xd.shape[0]


def stage_signatures(hashes: List[np.ndarray], bits: int, rb: int,
                     device: torch.device, bound: str = "mst",
                     row_sizes=None, col_sizes=None,
                     stats: Optional[dict] = None,
                     engine: str = "stream") -> Signatures:
    """One native pack (``pack_bitmaps_packed``) and one
    host-to-device copy per array, the spans ``<engine>.pack`` and
    ``<engine>.upload``.  ``stats`` receives their seconds (``pack_s``; the
    copies, waited for, ``stage_s``)."""
    with span(engine + ".pack", stats, "pack_s"):
        n = len(hashes)
        xp, coll = pack_bitmaps_packed(hashes, bits=bits, pad_n_to=rb)
        n_pad = xp.shape[0]
        sizes = np.zeros(n_pad, dtype=np.int32)
        if row_sizes is not None:
            sizes[:n] = np.asarray(row_sizes, dtype=np.int64)[:n]
        else:
            sizes[:n] = [len(h) for h in hashes]
        if bound == "minhash":
            cs = np.zeros(n_pad, dtype=np.int32)
            cs[:n] = np.asarray(col_sizes, dtype=np.int64)[:n]
            sizes = np.stack([sizes, cs])
    with span(engine + ".upload", stats, "stage_s"):
        sig = Signatures(_to_device(xp, device), _to_device(coll, device),
                         _to_device(sizes, device))
        if stats is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    return sig


def triangle_tiles(n_pad: int, rb: int):
    """(r0, c0) of the triangular tile sweep, rows then columns ascending
    (the order of the JAX build sweep and of ``_encode_clear``)."""
    return [(r0, c0) for r0 in range(0, n_pad, rb)
            for c0 in range(0, r0 + rb, rb)]


def candidate_pair_blocks(hashes: List[np.ndarray], threshold: float,
                          kmer_size: int, is_containment: bool = False,
                          bits: int = 8192, row_block: int = 1024,
                          bound: str = "mst", col_sizes=None,
                          markers: bool = False, row_sizes=None,
                          device: Optional[torch.device] = None):
    """Yields (ii, jj) int64 arrays of unverified candidate pairs (i > j),
    block by block in the JAX generator's order under the same
    ``RTC_PULL_MODE``; with ``markers`` also ("panel", row_end) once every
    pair with ii < row_end has been yielded.  ``BATCH_TILES`` tiles go into
    one K1 launch.  ``mask`` and ``auto`` pull each tile's packed mask and
    yield a block per tile with candidates; ``idx`` queues K3 behind each
    K1 (no pull between them), pulls the counts, then 4 bytes a candidate,
    and yields one block per batch.  Both give the pairs tile by tile,
    row-major within a tile, so the two concatenations are the same
    sequence."""
    from ..device import resolve_device
    pull_mode = os.environ.get("RTC_PULL_MODE", "auto")
    if pull_mode not in PULL_MODES:
        raise ValueError(f"RTC_PULL_MODE={pull_mode!r}: one of {PULL_MODES}")
    device = resolve_device(device)
    batch_k = BATCH_TILES
    n = len(hashes)
    rb = min(row_block, max(128, 1 << max(n - 1, 1).bit_length()))
    if pull_mode == "idx":
        _check_index_range(batch_k, rb)
    sig = stage_signatures(hashes, bits, rb, device, bound, row_sizes,
                           col_sizes)
    scalars = filter_scalars(threshold, kmer_size, bound)
    tiles = triangle_tiles(sig.n_pad, rb)
    batches = [tiles[b:b + batch_k] for b in range(0, len(tiles), batch_k)]

    def batch_markers(batch):
        # a row panel's pairs are complete once its diagonal tile is out
        return [("panel", min(r0 + rb, n)) for r0, c0 in batch if c0 == r0]

    idx = pull_mode == "idx"
    # idx: K3 writes batch b into bufs[b % 2] (``k3_buffer``), so that
    # batch b + 1's K1 and K3 are queued before the host waits on batch b's
    # indices
    bufs = [None, None]

    def dispatch(b):
        r0s = np.zeros(batch_k, dtype=np.int64)
        c0s = np.zeros(batch_k, dtype=np.int64)
        val = np.zeros(batch_k, dtype=np.int64)
        for t, (r0, c0) in enumerate(batches[b]):
            r0s[t], c0s[t], val[t] = r0, c0, 1
        counts, packs = batched_mask(sig.xd, sig.cd, sig.sd, r0s, c0s, val,
                                     *scalars, is_containment, rb, bound)
        n_valid = len(batches[b])
        if idx:  # straight behind K1, from its counts on the card; the
            # padding slots after the batch's tiles are left out
            out = bufs[b % 2] = k3_buffer(sig.xd.device, bufs[b % 2])
            compact_masks_into(packs[:n_valid], counts[:n_valid], out,
                               out.numel())
        return _host_async(counts), counts, packs, r0s, c0s, n_valid

    pending = dispatch(0) if batches else None
    for b, batch in enumerate(batches):
        counts_pending, counts_dev, packs_dev, r0s, c0s, n_valid = pending
        counts = _host_wait(counts_pending)
        account_pull(4 * batch_k)
        sel = [t for t in range(n_valid) if counts[t]]
        pull = None
        if sel and idx:
            total = int(counts.sum())
            out = bufs[b % 2] = k3_complete(
                packs_dev[:n_valid], counts_dev[:n_valid], bufs[b % 2], total)
            pull = _host_async(out[:total])
        elif sel:
            pull = _host_async(packs_dev.index_select(
                0, _upload(sel, packs_dev.device)))
        if b + 1 < len(batches):
            pending = dispatch(b + 1)
        if sel and idx:
            enc = _host_wait(pull).astype(np.int64)
            account_pull(4 * len(enc))
            t_loc = enc // (rb * rb)  # the tile's slot in the batch
            local = enc - t_loc * (rb * rb)
            ii = r0s[t_loc] + local // rb
            jj = c0s[t_loc] + local % rb
            keep = ii < n
            yield ii[keep], jj[keep]
        elif sel:
            packs = np.ascontiguousarray(_host_wait(pull))
            account_pull(packs.nbytes)
            for s_i, t in enumerate(sel):
                yield _decode_packed_mask(packs[s_i], rb, int(r0s[t]),
                                          int(c0s[t]), n, int(counts[t]))
        if markers:
            yield from batch_markers(batch)


# Source: rabbittclust_tpu/ops/bitmap.py::candidate_pairs_threshold
def candidate_pairs_threshold(hashes: List[np.ndarray], threshold: float,
                              kmer_size: int, is_containment: bool = False,
                              bits: int = 8192, row_block: int = 1024,
                              return_shared: bool = False,
                              device: Optional[torch.device] = None
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All pairs (i > j) that can possibly have distance <= threshold, with
    exact common counts.  Returns (i, j, common) — every returned pair passed
    the size-ratio filter and common >= 1; callers apply the distance.
    With ``return_shared`` the third column is zeros and no exact
    verification is performed."""
    cand_i: List[np.ndarray] = []
    cand_j: List[np.ndarray] = []
    for ii, jj in candidate_pair_blocks(
            hashes, threshold, kmer_size, is_containment=is_containment,
            bits=bits, row_block=row_block, device=device):
        cand_i.append(ii)
        cand_j.append(jj)
    if not cand_i:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty.copy(), np.empty(0, dtype=np.int64)
    ii = np.concatenate(cand_i)
    jj = np.concatenate(cand_j)
    if return_shared:
        return ii, jj, np.zeros(len(ii), dtype=np.int64)
    common = exact_common_counts(hashes, ii, jj)
    nz = common > 0
    return ii[nz], jj[nz], common[nz].astype(np.int64)


# Source: rabbittclust_tpu/ops/bitmap.py::exact_common_counts
def exact_common_counts(hashes: List[np.ndarray], ii: np.ndarray,
                        jj: np.ndarray, threads: int = 0) -> np.ndarray:
    """Exact |A_i ∩ A_j| for candidate pairs (native two-pointer)."""
    return CsrSketches(hashes).count_common(ii, jj, threads)
