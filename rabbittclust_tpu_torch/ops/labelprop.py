"""Resident-mask label-propagation clustering on the GPU (counterpart of
``rabbittclust_tpu/ops/labelprop.py``).

The candidate masks of a panel of triangular tiles are built once by K1
(``ops/bitmap.py::batched_mask``) and stay on the device.  Each round,
kernel K2 (``csrc/labelprop_round.cu``, wrappers ``lp_round`` and
``lp_round_compact``) clears the bits the host verified as failing and
proposes, under the current union-find labels, each row's and each
column's minimum cross-label candidate partner; the host pulls O(N)
proposals, verifies them exactly (native ``gated_verify_merge``),
merges the passes and pushes the new labels.  A panel is done when no
cross-label candidate is left in it; the labels carry into the next panel.
Panels, rounds, the compact pull after panel 0's round 1, the clear-list
encoding and the ``max_rounds`` host finish are the JAX engine's, so the
kept edges, and hence the clusters, are the same.

Left out: the fused host input of the tunnel (``_round_fn_*_hin``) and the
delta-label push (``RTC_LP_LABEL_DELTA``): labels and the clear list are
two plain pageable copies per round.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..cluster.mst import clusters_from_forest, sort_edges
from ..cluster.union_find import UnionFind
from ..utils.profiling import EventTimer, count, maybe_trace, span
from .bitmap import (
    CsrSketches,
    account_pull,
    batched_mask,
    filter_scalars,
    stage_signatures,
    triangle_tiles,
    unpack_bits,
)
from .cluster_fast import _gated_verify_block, gated_verify_merge
from .intersect import _launch, _upload
from .transfer import _host_async, _host_wait

# Source: rabbittclust_tpu/ops/labelprop.py::SENT
SENT = 1 << 30  # "no partner" in the proposals
LAUNCHES = {"labelprop_round": 0}
# K2's limits (csrc/labelprop_round.cu): the row block (the engines'
# largest) and the tiles of one launch (grid z)
MAX_RB = 16384
MAX_LAUNCH_TILES = 65535
# K2's blocks (csrc/labelprop_round.cu): the whole row of a band of rows of
# one tile up to rb = SPAN_FROM, a span of SPAN columns of it above, scanned
# by WARPS warps; the band from MAX_BAND down to MIN_BAND, or SPAN_MIN_BAND
# where a tile has several spans (``lp_band``)
SPAN = 4096
SPAN_FROM = 8192
MAX_BAND = 4096
MIN_BAND = 128
SPAN_MIN_BAND = 1024
WARPS = 8

# the last run's phases (host seconds, each the total of a span: pack_s
# lp.pack, stage_s lp.upload, csr_s lp.csr, pull_s lp.pull, verify_s
# lp.verify, finish_s lp.finish, total_s lp.engine less trace_s), counts and
# the device milliseconds of the builds and rounds (CUDA events); pulled
# bytes are in ops.bitmap.PULL_STATS; trace_s is RTC_PROFILE_DIR's
# profiler, in no phase
LP_STATS = {"pack_s": 0.0, "stage_s": 0.0, "csr_s": 0.0, "pull_s": 0.0,
            "verify_s": 0.0, "finish_s": 0.0, "total_s": 0.0, "rounds": 0,
            "panels": 0, "proposals": 0, "build_ms": 0.0, "round_ms": 0.0,
            "trace_s": 0.0}


def reset_launches() -> None:
    LAUNCHES["labelprop_round"] = 0


def reset_lp_stats() -> None:
    for k in LP_STATS:
        LP_STATS[k] = 0.0 if isinstance(LP_STATS[k], float) else 0


def _clear_plain(packs: torch.Tensor, clr: torch.Tensor, rb: int) -> None:
    """Clear the listed bits of ``packs`` in place.  ``clr`` is (4, C)
    int32: tile, row, byte, bit value (0 = no-op).  Entries that share a
    byte have their bit values OR-ed first, so none is lost."""
    t, r, b, sub = clr.long()
    flat = (t * rb + r) * (rb // 8) + b
    flat = torch.where(sub != 0, flat, torch.zeros_like(flat))
    uniq, inv = torch.unique(flat, return_inverse=True)
    shifts = torch.arange(8, device=clr.device)
    bits = (sub[:, None] >> shifts) & 1
    hit = torch.zeros((len(uniq), 8), dtype=torch.long, device=clr.device)
    hit.index_add_(0, inv, bits)
    clear = ((hit > 0).long() << shifts).sum(1).to(torch.uint8)
    view = packs.view(-1)
    view[uniq] = view[uniq] & ~clear


def round_plain(packs, labels, clr, r0s, c0s, valid, rb) -> torch.Tensor:
    """Plain K2 (``_round_fn``): clears ``clr`` from ``packs`` in place and
    returns fused = [cross, row_p (n_pad), col_p (n_pad)] int32."""
    _clear_plain(packs, clr, rb)
    dev = packs.device
    n_pad = labels.shape[0]
    row_p = torch.full((n_pad,), SENT, dtype=torch.int32, device=dev)
    col_p = torch.full((n_pad,), SENT, dtype=torch.int32, device=dev)
    cross = torch.zeros(1, dtype=torch.int32, device=dev)
    iota = torch.arange(rb, dtype=torch.int32, device=dev)
    sent = torch.tensor(SENT, dtype=torch.int32, device=dev)
    for t, (r0, c0, ok) in enumerate(zip(r0s.tolist(), c0s.tolist(),
                                         valid.tolist())):
        if not ok:
            continue
        m = unpack_bits(packs[t], torch.bool)
        m &= labels[r0:r0 + rb, None] != labels[None, c0:c0 + rb]
        cross += m.sum(dtype=torch.int32)
        rmin = torch.where(m, iota[None, :] + c0, sent).amin(1)
        cmin = torch.where(m, iota[:, None] + r0, sent).amin(0)
        row_p[r0:r0 + rb] = torch.minimum(row_p[r0:r0 + rb], rmin)
        col_p[c0:c0 + rb] = torch.minimum(col_p[c0:c0 + rb], cmin)
    return torch.cat([cross, row_p, col_p])


def compact_plain(fused, n_pad, r_lo, span, cap) -> torch.Tensor:
    """[cross, ncol, row_p[r_lo, +span), col_idx (cap), col_val (cap)]:
    the first ``cap`` proposing columns in ascending order, padded with
    index 0 (``jnp.nonzero(size=cap, fill_value=0)``).  A cumulative sum
    and a scatter, no host synchronisation."""
    row_p = fused[1:1 + n_pad]
    col_p = fused[1 + n_pad:]
    mask = col_p < SENT
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.zeros(cap + 1, dtype=torch.long, device=fused.device)
    idx.scatter_(0, slot, torch.arange(n_pad, device=fused.device))
    idx = idx[:cap]
    return torch.cat([fused[:1], mask.sum(dtype=torch.int32).view(1),
                      row_p[r_lo:r_lo + span], idx.to(torch.int32),
                      col_p[idx]])


def round_compact_plain(packs, labels, clr, r0s, c0s, valid, r_lo, rb,
                        span, cap) -> torch.Tensor:
    """Plain compact K2 (``_round_fn_compact``)."""
    fused = round_plain(packs, labels, clr, r0s, c0s, valid, rb)
    return compact_plain(fused, labels.shape[0], r_lo, span, cap)


def lp_span(rb: int) -> int:
    """The columns a K2 block takes (``span_of``): the whole row up to
    SPAN_FROM, SPAN above it."""
    return SPAN if rb > SPAN_FROM else rb


def lp_band(n_tiles: int, rb: int, sms: int) -> int:
    """K2's band (``band_of``): the widest from MAX_BAND down whose blocks
    spread over ``sms`` SMs within 10 %, but no narrower than MIN_BAND, or
    SPAN_MIN_BAND where a tile has several spans."""
    spans = -(-rb // lp_span(rb))
    floor_band = SPAN_MIN_BAND if spans > 1 else MIN_BAND
    band = min(rb, MAX_BAND)
    while True:
        blocks = n_tiles * spans * -(-rb // band)
        fullest = -(-blocks // sms)
        if band <= floor_band or 10 * fullest * sms <= 11 * blocks:
            return band
        band //= 2


def lp_walk(rb: int, band: int):
    """The rows and columns of one tile each (band, span, warp, lane group)
    of K2 reads, as the kernel's index arithmetic gives them: a list of
    (rows, columns), the rows in the order the lanes take them."""
    span = lp_span(rb)
    out = []
    for lo in range(0, rb, band):
        hi = min(lo + band, rb)
        for s0 in range(0, rb, span):
            chunks = min(span, rb - s0) // 128
            rpi = 1 if chunks >= 32 else 32 // chunks
            sub = -(-(hi - lo) // WARPS)
            sub = -(-sub // rpi) * rpi
            # a lane's chunks: lane + 32 k below ``chunks``, or lane % chunks
            lane_chunks = [[c for c in range(ln, chunks, 32)]
                           if chunks >= 32 else [ln % chunks]
                           for ln in range(32)]
            for w in range(WARPS):
                w_lo = lo + w * sub
                w_hi = min(w_lo + sub, hi)
                for grp in range(min(rpi, 32)):
                    lanes = [ln for ln in range(32)
                             if (0 if chunks >= 32 else ln // chunks) == grp]
                    cols = sorted({s0 + 128 * c + b for ln in lanes
                                   for c in lane_chunks[ln]
                                   for b in range(128)})
                    rows = [b + grp for b in range(w_lo, w_hi, rpi)
                            if b + grp < w_hi]
                    out.append((rows, cols))
    return out


def _check_round_inputs(packs, labels, clr, r0s, c0s, valid, rb):
    dev = packs.device
    if dev.type != "cuda":
        raise ValueError(f"masks on {dev}: expected cuda or cpu")
    if rb <= 0 or rb % 128 or rb > MAX_RB:
        raise ValueError(f"rb={rb}: K2 reads rows in 16-byte chunks, so rb "
                         "must be a multiple of 128, <= 16384")
    if (packs.dtype != torch.uint8 or packs.dim() != 3
            or tuple(packs.shape[1:]) != (rb, rb // 8)
            or not packs.is_contiguous() or packs.data_ptr() % 16):
        raise ValueError("masks must be a contiguous, 16-byte aligned "
                         "(T, rb, rb // 8) uint8 tensor")
    for name, t in (("labels", labels), ("clear list", clr), ("r0s", r0s),
                    ("c0s", c0s), ("valid", valid)):
        if (t.dtype != torch.int32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}")
    if clr.dim() != 2 or clr.shape[0] != 4:
        raise ValueError("the clear list must be (4, C)")
    if not r0s.shape == c0s.shape == valid.shape == (packs.shape[0],):
        raise ValueError("r0s, c0s and valid must have one entry per tile")
    if packs.shape[0] > MAX_LAUNCH_TILES:
        raise ValueError(f"{packs.shape[0]} tiles: K2 takes at most "
                         f"{MAX_LAUNCH_TILES} per launch")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def lp_round(packs, labels, clr, r0s, c0s, valid, rb,
             fused: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: ``round_plain``'s result, into ``fused`` when given (so a panel
    allocates its outputs once).  Tensors on the device; the masks are
    updated in place."""
    if packs.device.type == "cpu":
        return round_plain(packs, labels, clr, r0s, c0s, valid, rb)
    _check_round_inputs(packs, labels, clr, r0s, c0s, valid, rb)
    from ..kernels._build import load_kernels
    lib = load_kernels()
    n_pad = labels.shape[0]
    if fused is None:
        fused = torch.empty(1 + 2 * n_pad, dtype=torch.int32,
                            device=packs.device)
    with torch.cuda.device(packs.device):
        _launch(lib.rtc_lp_round, packs.data_ptr(), labels.data_ptr(),
                clr.data_ptr(), clr.shape[1], r0s.data_ptr(), c0s.data_ptr(),
                valid.data_ptr(), packs.shape[0], rb, n_pad,
                fused.data_ptr(), _stream(packs.device))
    LAUNCHES["labelprop_round"] += 1
    return fused


def lp_round_compact(packs, labels, clr, r0s, c0s, valid, r_lo, rb, span,
                     cap, work: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compact K2: ``round_compact_plain``'s result, into ``out`` (with
    ``work`` as the full round's scratch, which the compaction overwrites
    in part) when given."""
    if packs.device.type == "cpu":
        return round_compact_plain(packs, labels, clr, r0s, c0s, valid,
                                   r_lo, rb, span, cap)
    _check_round_inputs(packs, labels, clr, r0s, c0s, valid, rb)
    n_pad = labels.shape[0]
    if not (0 <= r_lo and r_lo + span <= n_pad and cap >= 0):
        raise ValueError(f"row span [{r_lo}, +{span}) or cap {cap} outside "
                         f"the {n_pad} labels")
    from ..kernels._build import load_kernels
    lib = load_kernels()
    dev = packs.device
    if work is None:
        work = torch.empty(1 + 2 * n_pad, dtype=torch.int32, device=dev)
    if out is None:
        out = torch.empty(2 + span + 2 * cap, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(lib.rtc_lp_round_compact, packs.data_ptr(),
                labels.data_ptr(), clr.data_ptr(), clr.shape[1],
                r0s.data_ptr(), c0s.data_ptr(), valid.data_ptr(),
                packs.shape[0], rb, n_pad, work.data_ptr(), r_lo, span, cap,
                out.data_ptr(), _stream(dev))
    LAUNCHES["labelprop_round"] += 1
    return out


def threshold_clusters_device_lp(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    bits: int = 8192,
    row_block: int = 8192,
    max_rounds: int = 256,
    panel_tiles: int = 0,
    device: Optional[torch.device] = None,
) -> List[List[int]]:
    """Exact single-linkage clusters at ``threshold`` (BFS-ordered like the
    reference MST cut), the clusters of the JAX
    ``threshold_clusters_device_lp``.  At most ``panel_tiles`` (default
    ``RTC_LP_PANEL_TILES`` = 512) mask tiles are resident at once."""
    if len(hashes) == 0:
        return []
    from ..device import resolve_device
    device = resolve_device(device)
    reset_lp_stats()
    if os.environ.get("RTC_LP_LABEL_DELTA", "0") == "1":
        print("-----note: RTC_LP_LABEL_DELTA is ignored (the port pushes "
              "the full labels every round)", file=sys.stderr)
    with span("lp.engine") as whole:
        clusters = _lp_clusters(hashes, threshold, kmer_size,
                                is_containment, bits, row_block, max_rounds,
                                panel_tiles, device)
    # the profiler's start, stop and export are in no timer
    LP_STATS["total_s"] = whole.seconds - LP_STATS["trace_s"]
    return clusters


def _lp_clusters(hashes, threshold, kmer_size, is_containment, bits,
                 row_block, max_rounds, panel_tiles, device):
    """The engine's body, between ``LP_STATS``' reset and its total."""
    n = len(hashes)
    cuda = device.type == "cuda"
    rb = min(row_block, max(128, 1 << max(n - 1, 1).bit_length()))
    n_pad = max(-(-n // rb) * rb, rb)  # pack_bitmaps_packed's padding
    tiles = triangle_tiles(n_pad, rb)
    if panel_tiles <= 0:
        panel_tiles = int(os.environ.get("RTC_LP_PANEL_TILES", "512"))
    t_cap = 1
    while t_cap < min(len(tiles), panel_tiles):
        t_cap *= 2
    # K2's limits on the card, checked before anything is staged
    if cuda and (rb % 128 or rb > MAX_RB):
        raise ValueError(f"row block {rb}: K2 reads rows in 16-byte chunks "
                         f"and takes row blocks of at most {MAX_RB}, so on "
                         f"the card it must be a multiple of 128, "
                         f"<= {MAX_RB}")
    if cuda and min(t_cap, len(tiles)) > MAX_LAUNCH_TILES:
        raise ValueError(f"a panel of {min(t_cap, len(tiles))} tiles "
                         f"(panel_tiles or RTC_LP_PANEL_TILES "
                         f"{panel_tiles}): K2 takes at most "
                         f"{MAX_LAUNCH_TILES} tiles per launch")
    sig = stage_signatures(hashes, bits, rb, device, stats=LP_STATS,
                           engine="lp")
    assert sig.n_pad == n_pad
    scalars = filter_scalars(threshold, kmer_size)

    panels = [tiles[p:p + t_cap] for p in range(0, len(tiles), t_cap)]
    panel_geo = [(min(r0 for r0, _ in panel),
                  max(r0 for r0, _ in panel) + rb) for panel in panels]
    multi = len(panels) > 1
    row_span = cap = 0
    if multi:
        row_span = min(n_pad, max(hi - lo for lo, hi in panel_geo))
        cap = min(n_pad, int(os.environ.get("RTC_LP_COL_CAP", "65536")))
    prefetch = os.environ.get("RTC_LP_PREFETCH", "1") != "0" and multi

    uf = UnionFind(n)
    csr = None  # built after the first build is queued (overlaps it)
    sizes64 = np.zeros(n_pad, dtype=np.int64)
    sizes64[:n] = [len(h) for h in hashes]
    kept_i: List[int] = []
    kept_j: List[int] = []
    kept_d: List[float] = []
    build_timer, round_timer = EventTimer(device), EventTimer(device)
    g = np.arange(n_pad, dtype=np.int64)

    def build(panel):
        with span("lp.build"):
            r0s = np.array([r0 for r0, _ in panel], dtype=np.int64)
            c0s = np.array([c0 for _, c0 in panel], dtype=np.int64)
            val = np.ones(len(panel), dtype=np.int64)
            _counts, packs = build_timer(batched_mask, sig.xd, sig.cd,
                                         sig.sd, r0s, c0s, val, *scalars,
                                         is_containment, rb)
            return packs, _upload(np.stack([r0s, c0s, val]), device)

    def labels_arr():
        roots = np.empty(n_pad, dtype=np.int32)
        roots[:n] = uf.roots_array()[:n]
        # padded rows keep distinct labels (they are maskless anyway)
        roots[n:] = n + np.arange(n_pad - n, dtype=np.int32)
        return roots

    def verify(fused, use_compact, r_lo, t_off):
        """Verify the round's proposals exactly and merge the passes; the
        next round's clear list."""
        if use_compact:
            ncol = int(fused[1])
            row_p = np.full(n_pad, SENT, dtype=np.int32)
            row_p[r_lo:r_lo + row_span] = fused[2:2 + row_span]
            col_p = np.full(n_pad, SENT, dtype=np.int32)
            k = min(ncol, cap)
            col_p[fused[2 + row_span:2 + row_span + k]] = \
                fused[2 + row_span + cap:2 + row_span + cap + k]
        else:
            row_p = fused[1:1 + n_pad]
            col_p = fused[1 + n_pad:]
        rp = row_p < SENT
        cp = col_p < SENT
        # rows first: they star-collapse most components, and the re-gate
        # below then drops most column proposals
        ri, rj = g[rp], row_p[rp].astype(np.int64)
        LP_STATS["proposals"] += len(ri)
        count("lp.proposals", len(ri))
        ki, kj, kd, ok_r = gated_verify_merge(
            uf, csr, sizes64, ri, rj, threshold, kmer_size, is_containment)
        count("lp.kept", len(ki))
        kept_i.extend(ki.tolist())
        kept_j.extend(kj.tolist())
        kept_d.extend(kd.tolist())
        ci, cj = col_p[cp].astype(np.int64), g[cp]
        roots = uf.roots_array()
        alive = roots[ci] != roots[cj]
        ci, cj = ci[alive], cj[alive]
        LP_STATS["proposals"] += len(ci)
        count("lp.proposals", len(ci))
        ki, kj, kd, ok_c = gated_verify_merge(
            uf, csr, sizes64, ci, cj, threshold, kmer_size, is_containment)
        count("lp.kept", len(ki))
        kept_i.extend(ki.tolist())
        kept_j.extend(kj.tolist())
        kept_d.extend(kd.tolist())
        # failed pairs -> the next round's clear list, each bit once
        fi = np.concatenate([ri[~ok_r], ci[~ok_c]])
        fj = np.concatenate([rj[~ok_r], cj[~ok_c]])
        if len(fi):
            _, sel = np.unique(fi * n_pad + fj, return_index=True)
            fi, fj = fi[sel], fj[sel]
        return _encode_clear(fi, fj, rb, t_off)

    next_build = None
    with maybe_trace("labelprop_cluster", device) as trace:
        for p_idx, panel in enumerate(panels):
            with span("lp.panel"):
                LP_STATS["panels"] += 1
                t_off = p_idx * t_cap  # global index of the panel's first tile
                packs, geo = (next_build if next_build is not None
                              else build(panel))
                next_build = None
                if csr is None:
                    with span("lp.csr", LP_STATS, "csr_s"):
                        csr = CsrSketches(hashes)
                r0s_d, c0s_d, val_d = geo
                empty = np.empty(0, dtype=np.int64)
                clr = _encode_clear(empty, empty, rb, t_off)
                r_lo = (min(panel_geo[p_idx][0], n_pad - row_span)
                        if multi else 0)
                fused_buf = work = out = None
                if cuda:  # the round's outputs, once per panel
                    fused_buf = torch.empty(1 + 2 * n_pad, dtype=torch.int32,
                                            device=device)
                    if multi:
                        work = fused_buf
                        out = torch.empty(2 + row_span + 2 * cap,
                                          dtype=torch.int32, device=device)
                rounds = 0
                converged = False
                while rounds < max_rounds:
                    rounds += 1
                    LP_STATS["rounds"] += 1
                    # panel 0 round 1: full pull; later rounds: compact pull
                    use_compact = multi and not (p_idx == 0 and rounds == 1)
                    with span("lp.round"):
                        labels_d = _upload(labels_arr(), device)
                        clr_d = _upload(np.stack([clr[0], clr[1], clr[2],
                                                  clr[3].astype(np.int32)]),
                                        device)
                        if use_compact:
                            res = round_timer(
                                lp_round_compact, packs, labels_d, clr_d,
                                r0s_d, c0s_d, val_d, r_lo, rb, row_span, cap,
                                work=work, out=out)
                        else:
                            res = round_timer(lp_round, packs, labels_d, clr_d,
                                              r0s_d, c0s_d, val_d, rb,
                                              fused=fused_buf)
                        pending = _host_async(res)
                    if prefetch and rounds == 1 and p_idx + 1 < len(panels):
                        # the next panel's build queues behind this round
                        # and runs while the host verifies
                        next_build = build(panels[p_idx + 1])
                    with span("lp.pull", LP_STATS, "pull_s"):
                        fused = _host_wait(pending)
                    account_pull(fused.nbytes)
                    if int(fused[0]) == 0:
                        converged = True
                        break
                    with span("lp.verify", LP_STATS, "verify_s"):
                        clr = verify(fused, use_compact, r_lo, t_off)
                if not converged:  # the exact host finish, from the masks
                    with span("lp.fallback"):
                        host_packs = packs.cpu().numpy()
                        account_pull(host_packs.nbytes)
                        _lp_fallback(host_packs, panel, rb, n, uf, csr,
                                     sizes64, threshold, kmer_size,
                                     is_containment, kept_i, kept_j, kept_d)
                del packs  # free this panel's masks before the next build

    LP_STATS["trace_s"] = trace.seconds

    with span("lp.finish", LP_STATS, "finish_s"):
        # the kept edges are union-find-gated, so they form a spanning
        # forest already: sorting them gives Kruskal's order for the BFS
        forest = sort_edges((np.asarray(kept_i, dtype=np.int64),
                             np.asarray(kept_j, dtype=np.int64),
                             np.asarray(kept_d, dtype=np.float64)))
        clusters = clusters_from_forest(forest, n)
    if cuda:
        LP_STATS["build_ms"] = build_timer.ms()
        LP_STATS["round_ms"] = round_timer.ms()
    return clusters


# Source: rabbittclust_tpu/ops/labelprop.py::_clear_quantum
def _clear_quantum(count: int) -> int:
    """Ladder for the clear-list length."""
    k = 1024
    while k < count:
        k *= 4
    return k


# Source: rabbittclust_tpu/ops/labelprop.py::_encode_clear
def _encode_clear(fi: np.ndarray, fj: np.ndarray, rb: int,
                  t_off: int = 0) -> Tuple[np.ndarray, ...]:
    """(t, row, byte, bit-value) clear-list arrays (ladder-padded) for
    failed pairs (i > j) in the triangular tile order of the build sweep.
    ``t_off`` rebases the global triangular tile index onto the current
    panel's local pack index (proposals only ever come from panel tiles)."""
    cap = _clear_quantum(len(fi))
    t = np.zeros(cap, dtype=np.int32)
    r = np.zeros(cap, dtype=np.int32)
    b = np.zeros(cap, dtype=np.int32)
    sub = np.zeros(cap, dtype=np.uint8)
    if len(fi):
        rblk = fi // rb
        cblk = fj // rb
        t[:len(fi)] = (rblk * (rblk + 1) // 2 + cblk - t_off).astype(
            np.int32)
        if t[:len(fi)].min() < 0:
            # a negative tile index would clear a bit of another panel's
            # mask: fail loudly (and survive ``python -O``)
            raise RuntimeError(
                "labelprop clear target outside current panel "
                f"(min rebased tile {int(t[:len(fi)].min())}, t_off={t_off})")
        r[:len(fi)] = (fi % rb).astype(np.int32)
        jl = fj % rb
        b[:len(fi)] = (jl // 8).astype(np.int32)
        sub[:len(fi)] = (1 << (jl % 8)).astype(np.uint8)
    return t, r, b, sub


# Source: rabbittclust_tpu/ops/labelprop.py::_lp_fallback (the caller
# pulls and accounts the masks)
def _lp_fallback(packs_np, tiles, rb, n, uf, csr, sizes64, threshold,
                 kmer_size, is_containment, kept_i, kept_j, kept_d):
    """Exact termination for pathological inputs that exhaust max_rounds:
    finish from the pulled resident masks with the union-find-gated host
    verifier (ops.cluster_fast semantics)."""
    roots = uf.roots_array()
    for t, (r0, c0) in enumerate(tiles):
        bits2d = np.unpackbits(packs_np[t], axis=1, bitorder="little")
        il, jl = np.nonzero(bits2d)
        ii = il.astype(np.int64) + r0
        jj = jl.astype(np.int64) + c0
        inb = (ii < n) & (jj < n)
        ii, jj = ii[inb], jj[inb]
        keep = roots[ii] != roots[jj]
        _gated_verify_block(uf, csr, sizes64, ii[keep], jj[keep], threshold,
                            kmer_size, is_containment, kept_i, kept_j,
                            kept_d)
        roots = uf.roots_array()
