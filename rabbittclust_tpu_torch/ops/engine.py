"""Dense exact-MST engine on the GPU (counterpart of
``rabbittclust_tpu/ops/engine.py``, compact pull only).

A triangular sweep of (rb x rb) tiles over the resident packed planes, in
batches of ``batch_k``: kernel K4 counts every pair of a batch, the mask
epilogue (torch, on the device) keeps the candidate pairs and bit-packs
them, the host pulls the per-tile counts and the packed masks of nonempty
tiles, decodes the surviving pairs natively, kernel K5b gathers their exact
common counts, and the host turns those into float64 distances and runs
the streaming Kruskal.  Tile order, ``rb``, ``batch_k`` and the budget
flush are the JAX engine's, so the MST arrays come out byte-equal.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..host import (
    DENSE_SPAN,
    Edges,
    MstResult,
    _decode_packed_mask,
    aaf_distance,
    concat_edges,
    kruskal,
    mash_distance,
    pack_sketches,
    size_ratio_limit,
)
from .bitmap import pack_mask_u8
from .intersect import _upload, pair_common, pair_counts_tiles
from .pack import DevicePlanes, planes_to_device


def _mst_batch(planes: DevicePlanes, r0s: np.ndarray, c0s: np.ndarray,
               valid: np.ndarray, radio: int, start_index: int, n: int,
               rb: int):
    """Counts (K4), then the mask epilogue of ``_mst_batch_fn``:
    ``counts > 0``, the int32 size-ratio gate, ``j < i``, ``i < n`` and
    ``i >= start_index``.  Returns per-tile candidate counts (batch,) int32
    and bit-packed masks (batch, rb, rb // 8) uint8, on the device."""
    dev = planes.plane0.device
    origin = _upload(np.stack([r0s, c0s, valid]), dev)
    counts = pair_counts_tiles(planes.plane0, planes.plane1, r0s, c0s, valid,
                               rb)
    span = torch.arange(rb, dtype=torch.int32, device=dev)
    rows = origin[0][:, None] + span  # (batch, rb) global row ids
    cols = origin[1][:, None] + span
    si = planes.sizes[rows.long()][:, :, None]
    sj = planes.sizes[cols.long()][:, None, :]
    mn = torch.minimum(si, sj)
    mx = torch.maximum(si, sj)
    m = (counts > 0) & (mn > 0) & (mx <= radio * mn)
    m &= cols[:, None, :] < rows[:, :, None]
    m &= ((rows < n) & (rows >= start_index))[:, :, None]
    m &= (origin[2] > 0)[:, None, None]
    return m.sum((1, 2), dtype=torch.int32), pack_mask_u8(m)


def _pair_common(planes: DevicePlanes, ii: np.ndarray,
                 jj: np.ndarray) -> np.ndarray:
    """Exact common counts for the surviving pairs (K5b), on the host."""
    return pair_common(planes.plane0, planes.plane1, ii, jj).cpu().numpy()


def _host_async(t: torch.Tensor):
    """Start a device-to-host copy into page-locked memory without waiting
    for the rest of the stream; ``_host_wait`` returns the numpy array.  A
    CPU tensor is returned as is."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _host_wait(pending) -> np.ndarray:
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return host.numpy()


# Source: rabbittclust_tpu/ops/engine.py::_edges_from_pairs (numpy only),
# copied because importing that module imports jax; a test holds the two
# equal.
def _edges_from_pairs(ii, jj, common, sizes, threshold, kmer_size,
                      is_containment, with_dense, dense, ani, radii):
    s0 = sizes[ii]
    s1 = sizes[jj]
    if is_containment:
        d = aaf_distance(common, s0, s1, kmer_size)
    else:
        d = mash_distance(common, s0, s1, kmer_size)
    if with_dense:
        t0 = np.searchsorted(radii, d, side="left")
        inb = t0 < DENSE_SPAN
        np.add.at(dense, (t0[inb], ii[inb]), 1)
        np.add.at(dense, (t0[inb], jj[inb]), 1)
        a = np.minimum(((1.0 - d) * 100.0).astype(np.int64), 100)
        np.add.at(ani, a, 1)
    return d


def compute_mst_device(hashes: List[np.ndarray], threshold: float,
                       kmer_size: int, is_containment: bool = False,
                       with_dense: bool = False, start_index: int = 0,
                       pre_edges: Optional[Edges] = None,
                       device: Optional[torch.device] = None,
                       row_block: int = 4096, batch_k: int = 8,
                       stats: Optional[dict] = None) -> MstResult:
    """Exact MST over all pairs with common >= 1 that pass the size-ratio
    filter.  ``device`` is explicit (see ``device.resolve_device``).
    ``stats``, when given, receives phase seconds (``pack_s``, ``h2d_s``,
    ``dispatch_s``, ``sweep_wait_s``, ``decode_s``, ``pair_common_s``,
    ``edges_s``, ``kruskal_s``), the device time of the tile sweep and of the pair
    gathers (``sweep_ms``, ``pair_common_ms``, CUDA only) and counts
    (``tiles``, ``batches``, ``candidates``)."""
    from ..device import resolve_device
    device = resolve_device(device)
    n = len(hashes)
    if n < 2:
        return MstResult(mst=(np.empty(0, np.int64), np.empty(0, np.int64),
                              np.empty(0, np.float64)), n=n,
                         dense=np.zeros((DENSE_SPAN, n), np.int64)
                         if with_dense else None,
                         ani=np.zeros(101, np.int64) if with_dense else None)
    st = {} if stats is None else stats
    for key in ("pack_s", "h2d_s", "dispatch_s", "sweep_wait_s", "decode_s",
                "pair_common_s", "edges_s", "kruskal_s"):
        st[key] = 0.0
    cuda = device.type == "cuda"
    clock = time.perf_counter

    t0 = clock()
    use64 = hashes[0].dtype == np.uint64
    rb = min(row_block, max(128, 1 << max(n - 1, 1).bit_length()))
    packed = pack_sketches(hashes, use64, pad_n_to=rb)
    sizes = packed.sizes.astype(np.int64)
    radio = size_ratio_limit(threshold, kmer_size - 1)
    if int(sizes[:n].max(initial=0)) * radio >= (1 << 31):
        raise ValueError("sketch sizes too large for int32 device ratio "
                         "filter; use the host engine")
    n_pad = packed.n
    st["pack_s"] = clock() - t0

    t0 = clock()
    planes = planes_to_device(packed, device)
    if cuda:
        torch.cuda.synchronize(device)
    st["h2d_s"] = clock() - t0

    dense = np.zeros((DENSE_SPAN, n), dtype=np.int64) if with_dense else None
    ani = np.zeros(101, dtype=np.int64) if with_dense else None
    radii = np.arange(DENSE_SPAN) / DENSE_SPAN

    # triangular square-tile sweep; append mode skips tiles fully below
    # start_index (the mask handles partial tiles)
    tiles = [(r0, c0) for r0 in range(0, n_pad, rb)
             for c0 in range(0, r0 + rb, rb) if r0 + rb > start_index]
    batches = [tiles[b:b + batch_k] for b in range(0, len(tiles), batch_k)]
    st.update(tiles=len(tiles), batches=len(batches), candidates=0)
    sweep_events, common_events = [], []

    def timed(events, fn, *args):
        if not cuda:
            return fn(*args)
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        out = fn(*args)
        ev1.record()
        events.append((ev0, ev1))
        return out

    def dispatch(b):
        t0 = clock()
        r0s = np.zeros(batch_k, dtype=np.int64)
        c0s = np.zeros(batch_k, dtype=np.int64)
        val = np.zeros(batch_k, dtype=np.int64)
        for t, (r0, c0) in enumerate(batches[b]):
            r0s[t], c0s[t], val[t] = r0, c0, 1
        cnts, packs = timed(sweep_events, _mst_batch, planes, r0s, c0s, val,
                            radio, start_index, n, rb)
        out = _host_async(cnts), packs, r0s, c0s, len(batches[b])
        st["dispatch_s"] += clock() - t0
        return out

    partial: List[Edges] = []
    if pre_edges is not None and len(pre_edges[0]):
        partial.append(pre_edges)
    budget = 0

    # one-batch lookahead: batch b+1 is queued before the host decodes b
    pending = dispatch(0) if batches else None
    for b in range(len(batches)):
        cnts_pending, packs_dev, r0s, c0s, n_valid = pending
        t0 = clock()
        cnts = _host_wait(cnts_pending)
        st["sweep_wait_s"] += clock() - t0
        sel = [t for t in range(n_valid) if cnts[t]]
        packs_pending = _host_async(packs_dev.index_select(
            0, _upload(sel, packs_dev.device))) if sel else None
        if b + 1 < len(batches):
            pending = dispatch(b + 1)
        if not sel:
            continue
        t0 = clock()
        packs = np.ascontiguousarray(_host_wait(packs_pending))
        ii_all, jj_all = [], []
        for s_i, t in enumerate(sel):
            ti, tj = _decode_packed_mask(packs[s_i], rb, int(r0s[t]),
                                         int(c0s[t]), n, int(cnts[t]))
            ii_all.append(ti)
            jj_all.append(tj)
        ii = np.concatenate(ii_all)
        jj = np.concatenate(jj_all)
        st["decode_s"] += clock() - t0
        t0 = clock()
        common = timed(common_events, _pair_common, planes, ii,
                       jj).astype(np.int64)
        st["pair_common_s"] += clock() - t0
        t0 = clock()
        d = _edges_from_pairs(ii, jj, common, sizes, threshold, kmer_size,
                              is_containment, with_dense, dense, ani, radii)
        partial.append((ii.astype(np.int64), jj.astype(np.int64), d))
        st["candidates"] += len(ii)
        st["edges_s"] += clock() - t0
        budget += len(ii)
        if budget > 4 * n:
            t0 = clock()
            partial = [kruskal(concat_edges(partial), n)]
            budget = len(partial[0][0])
            st["kruskal_s"] += clock() - t0

    t0 = clock()
    mst = kruskal(concat_edges(partial), n)
    st["kruskal_s"] += clock() - t0
    if with_dense:
        dense = np.cumsum(dense, axis=0)
    if cuda:
        torch.cuda.synchronize(device)
        st["sweep_ms"] = sum(a.elapsed_time(z) for a, z in sweep_events)
        st["pair_common_ms"] = sum(a.elapsed_time(z)
                                   for a, z in common_events)
    return MstResult(mst=mst, n=n, dense=dense, ani=ani)
