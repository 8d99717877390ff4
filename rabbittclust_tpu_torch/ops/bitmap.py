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
* ``candidate_pair_blocks`` — the stream engine's batched generator: batch
  b+1's K1 is queued before batch b's masks are decoded on the host.  It
  pulls packed masks only (the index-compaction arm, K3, is not ported).

The wrapper runs the plain version only when the signatures lie on the
CPU; on a CUDA tensor it launches the kernel or raises.  ``LAUNCHES``
counts kernel launches.  ``pack_mask_u8`` is shared with the dense engine.
"""

from __future__ import annotations

import ctypes
import math
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..distance.mash import min_jaccard_for_threshold, size_ratio_limit
from ..utils import native as native_mod
from .intersect import _launch, _upload
from .pack import _to_device
from .transfer import _host_async, _host_wait

LAUNCHES = {"filter_mask": 0}
BOUNDS = {"mst": 0, "greedy": 1, "minhash": 2}
# tiles per K1 launch of the stream generator (the JAX generator's default)
BATCH_TILES = 16

# device-to-host bytes and pulls of the filter (reset_pull_stats() zeroes)
PULL_STATS = {"bytes": 0, "pulls": 0}


def reset_launches() -> None:
    LAUNCHES["filter_mask"] = 0


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
                    radio, is_containment, bound="mst") -> torch.Tensor:
    """Safe candidate mask (rb, rb) bool of the tile rows [r0, +rb) x
    columns [c0, +rb); the operations of ``_tile_mask``, in its order.
    The float32 product of 0/1 values is exact (counts < 2^24)."""
    dev = xd.device
    f32 = torch.float32
    xi = unpack_bits(xd[r0:r0 + rb])
    xj = unpack_bits(xd[c0:c0 + rb])
    ci, cj = cd[r0:r0 + rb], cd[c0:c0 + rb]
    if bound == "minhash":
        si, sj = sd[0, r0:r0 + rb], sd[1, c0:c0 + rb]
    else:
        si, sj = sd[r0:r0 + rb], sd[c0:c0 + rb]
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
        ratio_ok = (mni > 0) & (mxi <= int(radio) * mni)
    span = torch.arange(rb, dtype=torch.int32, device=dev)
    lower = (span[None, :] + c0) < (span[:, None] + r0)
    return (shared >= thresh) & ratio_ok & lower


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


def _check_filter_inputs(xd, cd, sd, bound, rb, r0s, c0s, valid):
    if xd.device.type != "cuda":
        raise ValueError(f"signatures on {xd.device}: expected cuda or cpu")
    if (xd.dtype != torch.uint8 or xd.dim() != 2 or not xd.is_contiguous()
            or xd.shape[1] % 8 or xd.shape[1] == 0):
        raise ValueError("signatures must be a contiguous (n_pad, bits // 8)"
                         " uint8 tensor with whole 64-bit words")
    n_pad = xd.shape[0]
    want_sd = (2, n_pad) if bound == "minhash" else (n_pad,)
    for name, t, shape in (("collisions", cd, (n_pad,)),
                           ("sizes", sd, want_sd)):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != xd.device):
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on {xd.device}")
    if rb <= 0 or rb % 32:
        raise ValueError(f"rb={rb}: must be a positive multiple of 32")
    live = valid != 0
    if live.any() and (min(r0s[live].min(), c0s[live].min()) < 0 or
                       max(r0s[live].max(), c0s[live].max()) + rb > n_pad):
        raise ValueError(f"a tile of {rb} rows leaves the {n_pad} padded "
                         "signatures")


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
    from ..kernels._build import load_kernels
    lib = load_kernels()
    k = len(r0s)
    dev = xd.device
    idx = _upload(np.stack([r0s, c0s, valid != 0]), dev)
    counts = torch.zeros(k, dtype=torch.int32, device=dev)
    packs = torch.empty((k, rb, rb // 8), dtype=torch.uint8, device=dev)
    rows = sd[0] if bound == "minhash" else sd
    cols = sd[1] if bound == "minhash" else sd
    radio_i = int(radio) if bound == "mst" else 0
    radio_f = float(radio) if bound == "greedy" else 0.0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.rtc_filter_mask, xd.data_ptr(), xd.shape[1] // 8,
                cd.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                idx[0].data_ptr(), idx[1].data_ptr(), idx[2].data_ptr(), k,
                rb, ctypes.c_float(float(jmin_num)),
                ctypes.c_float(float(jmin_den)),
                ctypes.c_float(float(c_min)), radio_i,
                ctypes.c_float(radio_f), int(bool(is_containment)),
                BOUNDS[bound], counts.data_ptr(), packs.data_ptr(), stream)
    LAUNCHES["filter_mask"] += 1
    return counts, packs


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
                     stats: Optional[dict] = None) -> Signatures:
    """One native pack (``pack_bitmaps_packed``) and one
    host-to-device copy per array.  ``stats`` receives the seconds of the
    pack (``pack_s``) and of the copies, waited for (``stage_s``)."""
    clock = time.perf_counter
    t0 = clock()
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
    t1 = clock()
    sig = Signatures(_to_device(xp, device), _to_device(coll, device),
                     _to_device(sizes, device))
    if stats is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["pack_s"] = t1 - t0
        stats["stage_s"] = clock() - t1
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
    block by block in the JAX generator's order under
    ``RTC_PULL_MODE=mask``; with ``markers`` also ("panel", row_end) once
    every pair with ii < row_end has been yielded.  ``BATCH_TILES`` tiles
    go into one K1 launch."""
    from ..device import resolve_device
    device = resolve_device(device)
    batch_k = BATCH_TILES
    n = len(hashes)
    rb = min(row_block, max(128, 1 << max(n - 1, 1).bit_length()))
    sig = stage_signatures(hashes, bits, rb, device, bound, row_sizes,
                           col_sizes)
    scalars = filter_scalars(threshold, kmer_size, bound)
    tiles = triangle_tiles(sig.n_pad, rb)
    batches = [tiles[b:b + batch_k] for b in range(0, len(tiles), batch_k)]

    def batch_markers(batch):
        # a row panel's pairs are complete once its diagonal tile is out
        return [("panel", min(r0 + rb, n)) for r0, c0 in batch if c0 == r0]

    def dispatch(batch):
        r0s = np.zeros(batch_k, dtype=np.int64)
        c0s = np.zeros(batch_k, dtype=np.int64)
        val = np.zeros(batch_k, dtype=np.int64)
        for t, (r0, c0) in enumerate(batch):
            r0s[t], c0s[t], val[t] = r0, c0, 1
        counts, packs = batched_mask(sig.xd, sig.cd, sig.sd, r0s, c0s, val,
                                     *scalars, is_containment, rb, bound)
        return _host_async(counts), packs, r0s, c0s, len(batch)

    pending = dispatch(batches[0]) if batches else None
    for b, batch in enumerate(batches):
        counts_pending, packs_dev, r0s, c0s, n_valid = pending
        counts = _host_wait(counts_pending)
        account_pull(4 * batch_k)
        sel = [t for t in range(n_valid) if counts[t]]
        packs_pending = _host_async(packs_dev.index_select(
            0, _upload(sel, packs_dev.device))) if sel else None
        if b + 1 < len(batches):
            pending = dispatch(batches[b + 1])
        if sel:
            packs = np.ascontiguousarray(_host_wait(packs_pending))
            account_pull(packs.nbytes)
            for s_i, t in enumerate(sel):
                yield _decode_packed_mask(packs[s_i], rb, int(r0s[t]),
                                          int(c0s[t]), n, int(counts[t]))
        if markers:
            yield from batch_markers(batch)
