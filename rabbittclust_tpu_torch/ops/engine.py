"""Dense exact-MST engine on the GPU (counterpart of
``rabbittclust_tpu/ops/engine.py``, compact pull only).

A triangular sweep of (rb x rb) tiles over the resident packed planes, in
batches of ``batch_k``: kernel K4 in its mask mode finds the pairs of a
batch with a common hash, keeps those that pass the size-ratio gate and
the triangle and bit-packs them (the counts never reach device memory),
the host pulls the per-tile counts and the packed masks of nonempty
tiles, decodes the surviving pairs natively, kernel K5b gathers their exact
common counts, and the host turns those into float64 distances and runs
the streaming Kruskal.  Tile order, ``rb``, ``batch_k`` and the budget
flush are the JAX engine's, so the MST arrays come out byte-equal.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..cluster.mst import DENSE_SPAN, Edges, MstResult, concat_edges, kruskal
from ..distance.mash import aaf_distance, mash_distance, size_ratio_limit
from ..utils.profiling import EventTimer, maybe_trace, span
from .bitmap import _decode_packed_mask
from .intersect import _upload, pair_common, pair_mask_tiles
from .pack import DevicePlanes, pack_sketches, planes_to_device
from .transfer import _host_async, _host_wait


def _pair_common(planes: DevicePlanes, ii: np.ndarray,
                 jj: np.ndarray) -> np.ndarray:
    """Exact common counts for the surviving pairs (K5b), on the host."""
    return pair_common(planes.plane0, planes.plane1, ii, jj).cpu().numpy()


# Source: rabbittclust_tpu/ops/engine.py::_edges_from_pairs (numpy only); a
# test holds the two equal.
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
    ``stats``, when given, receives phase seconds, each the total of a
    span (``pack_s`` of ``dense.pack``, ``h2d_s`` ``dense.upload``,
    ``compact_s`` ``dense.compact``, ``dispatch_s`` ``dense.dispatch``,
    ``sweep_wait_s`` ``dense.sweep_wait``, ``decode_s`` ``dense.decode``,
    ``pair_common_s`` ``dense.pair_common``, ``edges_s`` ``dense.edges``,
    ``kruskal_s`` ``dense.kruskal``; ``trace_s``, the profiler's under
    ``RTC_PROFILE_DIR``), the device time of the
    tile sweep and of the pair gathers (``sweep_ms``, ``pair_common_ms``,
    CUDA only) and counts (``tiles``, ``batches``, ``candidates``)."""
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
    for key in ("pack_s", "h2d_s", "compact_s", "dispatch_s", "sweep_wait_s",
                "decode_s", "pair_common_s", "edges_s", "kruskal_s"):
        st[key] = 0.0
    cuda = device.type == "cuda"

    with span("dense.pack", st, "pack_s"):
        use64 = hashes[0].dtype == np.uint64
        rb = min(row_block, max(128, 1 << max(n - 1, 1).bit_length()))
        packed = pack_sketches(hashes, use64, pad_n_to=rb)
        sizes = packed.sizes.astype(np.int64)
        radio = size_ratio_limit(threshold, kmer_size - 1)
        if int(sizes[:n].max(initial=0)) * radio >= (1 << 31):
            raise ValueError("sketch sizes too large for int32 device "
                             "ratio filter; use the host engine")
        n_pad = packed.n

    with span("dense.upload", st, "h2d_s"):
        planes = planes_to_device(packed, device)
        if cuda:
            torch.cuda.synchronize(device)
    with span("dense.compact", st, "compact_s"):
        if cuda:  # the kernels' compact form, built on the device
            planes.compact()
            torch.cuda.synchronize(device)

    dense = np.zeros((DENSE_SPAN, n), dtype=np.int64) if with_dense else None
    ani = np.zeros(101, dtype=np.int64) if with_dense else None
    radii = np.arange(DENSE_SPAN) / DENSE_SPAN

    # triangular square-tile sweep; append mode skips tiles fully below
    # start_index (the mask handles partial tiles)
    tiles = [(r0, c0) for r0 in range(0, n_pad, rb)
             for c0 in range(0, r0 + rb, rb) if r0 + rb > start_index]
    batches = [tiles[b:b + batch_k] for b in range(0, len(tiles), batch_k)]
    st.update(tiles=len(tiles), batches=len(batches), candidates=0)
    sweep_timer, common_timer = EventTimer(device), EventTimer(device)

    def dispatch(b):
        with span("dense.dispatch", st, "dispatch_s"):
            r0s = np.zeros(batch_k, dtype=np.int64)
            c0s = np.zeros(batch_k, dtype=np.int64)
            val = np.zeros(batch_k, dtype=np.int64)
            for t, (r0, c0) in enumerate(batches[b]):
                r0s[t], c0s[t], val[t] = r0, c0, 1
            # _mst_batch_fn: K4's mask mode on CUDA (the counts stay on
            # chip), the plain counts and the torch epilogue on the CPU
            cnts, packs = sweep_timer(pair_mask_tiles, planes.plane0,
                                      planes.plane1, planes.sizes, r0s, c0s,
                                      val, radio, start_index, n, rb)
            return _host_async(cnts), packs, r0s, c0s, len(batches[b])

    partial: List[Edges] = []
    if pre_edges is not None and len(pre_edges[0]):
        partial.append(pre_edges)
    budget = 0

    # one-batch lookahead: batch b+1 is queued before the host decodes b
    with maybe_trace("dense_mst_device_compact", device) as trace:
        pending = dispatch(0) if batches else None
        for b in range(len(batches)):
            cnts_pending, packs_dev, r0s, c0s, n_valid = pending
            with span("dense.sweep_wait", st, "sweep_wait_s"):
                cnts = _host_wait(cnts_pending)
            sel = [t for t in range(n_valid) if cnts[t]]
            packs_pending = _host_async(packs_dev.index_select(
                0, _upload(sel, packs_dev.device))) if sel else None
            if b + 1 < len(batches):
                pending = dispatch(b + 1)
            if not sel:
                continue
            with span("dense.decode", st, "decode_s"):
                packs = np.ascontiguousarray(_host_wait(packs_pending))
                ii_all, jj_all = [], []
                for s_i, t in enumerate(sel):
                    ti, tj = _decode_packed_mask(packs[s_i], rb,
                                                 int(r0s[t]), int(c0s[t]),
                                                 n, int(cnts[t]))
                    ii_all.append(ti)
                    jj_all.append(tj)
                ii = np.concatenate(ii_all)
                jj = np.concatenate(jj_all)
            with span("dense.pair_common", st, "pair_common_s"):
                common = common_timer(_pair_common, planes, ii,
                                      jj).astype(np.int64)
            with span("dense.edges", st, "edges_s"):
                d = _edges_from_pairs(ii, jj, common, sizes, threshold,
                                      kmer_size, is_containment, with_dense,
                                      dense, ani, radii)
                partial.append((ii.astype(np.int64), jj.astype(np.int64),
                                d))
                st["candidates"] += len(ii)
            budget += len(ii)
            if budget > 4 * n:
                with span("dense.kruskal", st, "kruskal_s"):
                    partial = [kruskal(concat_edges(partial), n)]
                budget = len(partial[0][0])
    st["trace_s"] = trace.seconds  # RTC_PROFILE_DIR's cost, in no timer

    with span("dense.kruskal", st, "kruskal_s"):
        mst = kruskal(concat_edges(partial), n)
    if with_dense:
        dense = np.cumsum(dense, axis=0)
    if cuda:
        st["sweep_ms"] = sweep_timer.ms()
        st["pair_common_ms"] = common_timer.ms()
    return MstResult(mst=mst, n=n, dense=dense, ani=ani)
