"""Greedy clustering with device candidates (counterpart of
``rabbittclust_tpu/ops/greedy_device.py``, the single-sweep engines).

Reps are always earlier genomes in processing order, so the triangular
candidate set {(j, i): i < j passing the greedy bound} is a superset of
every (genome, rep) pair the serial loop can score.  One sweep of the
stream generator (``ops/bitmap.py::candidate_pair_blocks``, kernel K1 under
its ``greedy`` or ``minhash`` bound) streams that set row by row, and the
host replays the serial loop with exact common counts — bit-exact against
the native engines of ``cluster/greedy.py``, ties included.

The batched conflict mode (``conflict="batched"``, the reference's
experimental batched variant) runs kernel K6 (``greedy_filter``: K1's
gathered form in ``csrc/filter_mask.cu`` and K3's row form in
``csrc/mask_compact.cu``), which replaces the JAX ``_greedy_filter_fn``:
each batch's candidate (member, rep) pairs against the rep snapshot,
verified exactly on the host.  ``greedy_filter_plain`` is its plain torch
version.  The legacy per-batch loop (``RTC_GREEDY_DEVICE=batchloop``) is
not ported: it runs the sweep, which gives the same clusters.
"""

from __future__ import annotations

import ctypes
import math
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..cluster.greedy import GreedyResult, minhash_greedy_parity
from ..distance.mash import aaf_distance, mash_distance, \
    min_jaccard_for_threshold
from .bitmap import (BLOCK, MASK_COMPACT_SEG, CsrSketches,
                     _check_flat_range, _check_signatures,
                     candidate_pair_blocks, compact_mask_two_level_plain,
                     launch_k3, pack_bitmaps_packed, tile_geometry,
                     unpack_bits)
from .intersect import _upload
from .pack import _to_device

LAUNCHES = {"greedy_filter": 0}


def reset_launches() -> None:
    LAUNCHES["greedy_filter"] = 0


# Source: rabbittclust_tpu/ops/greedy_device.py::_first_shared_pos
def _first_shared_pos(inv: List[np.ndarray], j: int, r: int) -> int:
    """Position, in genome j's sorted hash array, of the first hash shared
    with rep r — the probe-touch key of the serial host engine (sketches
    are sorted ascending, so the first shared hash in probe order is the
    smallest common hash)."""
    common = np.intersect1d(inv[j], inv[r], assume_unique=True)
    return int(np.searchsorted(inv[j], common[0]))


# Source: rabbittclust_tpu/ops/greedy_device.py::_sweep_rows
def _sweep_rows(hashes: List[np.ndarray], threshold: float, kmer_size: int,
                is_containment: bool, bits: int, row_block: int,
                bound: str, col_sizes=None, row_sizes=None,
                device: Optional[torch.device] = None):
    """Stream (j, candidate row indices int32) for j = 1..n-1 IN ORDER from
    one triangular device sweep, buffering at most one row PANEL of
    candidate pairs (candidate_pair_blocks markers=True) — memory stays
    O(row_block * N * density) instead of O(N^2 * density) pairs."""
    n = len(hashes)
    buf = {}
    next_row = 1  # row 0 never has candidates (pairs have i > j)
    empty = np.empty(0, dtype=np.int32)
    for item in candidate_pair_blocks(
            hashes, threshold, kmer_size, is_containment=is_containment,
            bits=bits, row_block=row_block, bound=bound,
            col_sizes=col_sizes, markers=True, row_sizes=row_sizes,
            device=device):
        if isinstance(item[0], str):  # ("panel", row_end)
            row_end = min(item[1], n)
            for j in range(next_row, row_end):
                parts = buf.pop(j, None)
                yield j, (np.concatenate(parts) if parts else empty)
            next_row = max(next_row, row_end)
            continue
        ii, jj = item
        ii = ii.astype(np.int32)
        jj = jj.astype(np.int32)
        o = np.argsort(ii, kind="stable")
        ii_s, jj_s = ii[o], jj[o]
        cuts = np.flatnonzero(np.diff(ii_s)) + 1
        bounds = np.r_[0, cuts, len(ii_s)]
        for a, b in zip(bounds[:-1], bounds[1:]):
            buf.setdefault(int(ii_s[a]), []).append(jj_s[a:b])
    for j in range(next_row, n):  # guard: markers should have covered all
        parts = buf.pop(j, None)
        yield j, (np.concatenate(parts) if parts else empty)


def _replay(rows, stats: Optional[dict]):
    """Iterate ``rows`` of ``_sweep_rows``; when ``stats`` is given, add
    the seconds spent waiting on the sweep (``sweep_s``: device filter,
    pulls, mask decode) and in the caller's loop body (``replay_s``)."""
    if stats is None:
        yield from rows
        return
    clock = time.perf_counter
    stats.setdefault("sweep_s", 0.0)
    stats.setdefault("replay_s", 0.0)
    t0 = clock()
    for row in rows:
        t1 = clock()
        stats["sweep_s"] += t1 - t0
        yield row
        t0 = clock()
        stats["replay_s"] += t0 - t1
    stats["sweep_s"] += clock() - t0


# Source: rabbittclust_tpu/ops/greedy_device.py::_greedy_serial_sweep
def _greedy_serial_sweep(inv: List[np.ndarray], sizes: np.ndarray,
                         threshold: float, kmer_size: int,
                         is_containment: bool, bits: int,
                         row_block: int = 4096,
                         device: Optional[torch.device] = None,
                         stats: Optional[dict] = None):
    """Serial greedy replay over ONE triangular all-pairs device sweep
    (bound="greedy").  Exact common counts are computed LAZILY on the host,
    per genome, restricted to candidates that are reps at that genome's
    turn — decisions replicate cluster.greedy.greedy_cluster bit-for-bit
    (reference greedy.cpp:566-899) including exact-similarity ties
    (first-touched rep = minimal (first-shared-hash position, creation
    rank)).  Returns (rep_order, members)."""
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    csr = CsrSketches(inv)
    n = len(inv)

    sizes_f = sizes.astype(np.float64)
    rep_order: List[int] = [0]
    members = {0: []}
    rep_rank = {0: 0}
    is_rep = np.zeros(n, dtype=bool)
    is_rep[0] = True
    for j, cand in _replay(_sweep_rows(inv, threshold, kmer_size,
                                       is_containment, bits, row_block,
                                       "greedy", device=device), stats):
        cand = cand[is_rep[cand]]
        best_rep = -1
        if cand.size:
            common = csr.count_common(
                np.full(cand.size, j, dtype=np.int64),
                cand).astype(np.int64)
            # exact f64 accept bound + similarity, replicating the serial
            # host engine bit-for-bit (greedy_cluster / reference
            # greedy.cpp:770-816): the integer common-count bound IS the
            # decision; comparisons use the f64 similarity
            sj = sizes_f[j]
            sr = sizes_f[cand]
            if is_containment:
                den = np.minimum(sj, sr)
                ok = common >= np.ceil(c_min * den)
            else:
                ok = common >= np.ceil(j_min * (sj + sr) / (1.0 + j_min))
                den = sj + sr - common
            if ok.any():
                c_ok = cand[ok]
                den_ok = den[ok]
                zero = den_ok == 0
                sim = np.where(zero, 1.0,
                               common[ok] / np.where(zero, 1.0, den_ok))
                best = sim.max()
                tied = c_ok[sim == best]
                if tied.size > 1:
                    # exact-similarity tie: the serial host's winner is the
                    # FIRST-TOUCHED rep during the index probe
                    best_rep = min(
                        (int(r) for r in tied),
                        key=lambda r: (_first_shared_pos(inv, j, r),
                                       rep_rank[r]))
                else:
                    best_rep = int(tied[0])
        if best_rep != -1:
            members[best_rep].append(j)
        else:
            rep_rank[j] = len(rep_order)
            rep_order.append(j)
            members[j] = []
            is_rep[j] = True
    return rep_order, members


# Source: rabbittclust_tpu/ops/greedy_device.py::minhash_greedy_device
def minhash_greedy_device(
    hashes: List[np.ndarray],
    param_sizes,
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    bits: int = 8192,
    row_block: int = 4096,
    device: Optional[torch.device] = None,
    stats: Optional[dict] = None,
) -> GreedyResult:
    """Device-swept MinHash-parity greedy — BIT-EXACT vs
    cluster.greedy.minhash_greedy_parity (the reference's default
    clust-greedy MinHash engine, MinHashGreedyClusterWithInvertedIndex,
    src/greedy.cpp:986-1360) including first-touch tie order.

    One triangular all-pairs sweep (bound="minhash": query side = actual
    kept-hash count, rep side = the reference's per-genome param size —
    the asymmetry greedy.cpp has) yields a candidate superset of every
    (genome, rep) probe; the serial loop is replayed on the host with
    exact common counts and the reference's metric:
      * fast path (first min(100, n) genomes standard-mode with identical
        param size): fixed bound, winner = max common, no distance;
      * slow path: per-pair bound, MASH-transform distance of containment
        or jaccard (libm log via math.log — NumPy's SIMD log is 1 ulp
        off), winner = min distance;
    strict comparisons in first-touch order = minimal
    (first-shared-hash position, rep creation rank).

    threshold >= 1.0 falls back to the host engine: the reference clamps
    distances to 1.0, so EVERY probed pair becomes acceptable and no
    common-count bound can express the accept set."""
    n = len(hashes)
    if n == 0:
        return GreedyResult([], [], np.empty(0, dtype=np.int64))
    if threshold >= 1.0:
        return minhash_greedy_parity(hashes, list(param_sizes), threshold,
                                     kmer_size, is_containment)

    x = math.exp(-threshold * kmer_size)
    j_min = x / (2.0 - x)
    psizes = np.asarray(param_sizes, dtype=np.int64)
    sample = min(100, n)
    fast = (not is_containment) and all(
        int(psizes[i]) == int(psizes[0]) for i in range(1, sample))
    fixed_common_min = (int(math.ceil(j_min * (2 * int(psizes[0]))
                                      / (1.0 + j_min))) if fast else 0)

    if fast:
        # the fast path accepts with ONE fixed bound ceil(jmin*2*S0/(1+jmin))
        # for EVERY pair regardless of actual/param sizes (only the first
        # min(100, n) genomes are sampled; later ones may differ) — feed
        # the filter constant S0 sizes on BOTH axes so its per-pair bound
        # floor(jmin*2*S0/(1+jmin))-1 can never exceed the fixed accept
        # bound (with actual sizes, a later larger genome's bound could
        # prune a pair the reference's fast path accepts)
        const_s = np.full(n, int(psizes[0]), dtype=np.int64)
        filt_cols = filt_rows = const_s
    else:
        filt_cols, filt_rows = psizes, None  # actual kept counts per row

    csr = CsrSketches(hashes)
    rep_order: List[int] = [0]
    members = {0: []}
    rep_rank = {0: 0}
    is_rep = np.zeros(n, dtype=bool)
    is_rep[0] = True
    for j, cand in _replay(_sweep_rows(
            hashes, threshold, kmer_size, is_containment, bits, row_block,
            "minhash", col_sizes=filt_cols, row_sizes=filt_rows,
            device=device), stats):
        cand = cand[is_rep[cand]]
        best_rep = -1
        if cand.size:
            common = csr.count_common(
                np.full(cand.size, j, dtype=np.int64),
                cand).astype(np.int64)
            size_ref = len(hashes[j])  # the reference's size_ref = QUERY
            best_metric = None
            tied: List[int] = []
            for r, cm in zip(cand.tolist(), common.tolist()):
                if cm <= 0:
                    continue  # the index probe never touches disjoint reps
                size_qry = int(psizes[r])
                if fast:
                    if cm < fixed_common_min:
                        continue
                    metric = -cm
                else:
                    if is_containment:
                        if cm < math.ceil(j_min * min(size_ref, size_qry)):
                            continue
                        mn = min(size_ref, size_qry)
                        jac = 0.0 if mn == 0 else cm / mn
                        if mn == 0:
                            dist = 1.0
                        elif jac >= 1.0:
                            dist = 0.0
                        elif jac <= 0.0:
                            dist = 1.0
                        else:
                            dist = min(1.0,
                                       -math.log(2.0 * jac / (1.0 + jac))
                                       / kmer_size)
                    else:
                        if cm < math.ceil(j_min * (size_ref + size_qry)
                                          / (1.0 + j_min)):
                            continue
                        denom = size_ref + size_qry - cm
                        if denom == 0:
                            dist = 0.0
                        else:
                            jac = cm / denom
                            if jac >= 1.0:
                                dist = 0.0
                            elif jac <= 0.0:
                                dist = 1.0
                            else:
                                dist = min(1.0,
                                           -math.log(2.0 * jac / (1.0 + jac))
                                           / kmer_size)
                    if dist > threshold:
                        continue
                    metric = dist
                # track metric-equal ties; the O(s) first-touch key is
                # resolved lazily, only among exact ties (rare)
                if best_metric is None or metric < best_metric:
                    best_metric, tied = metric, [r]
                elif metric == best_metric:
                    tied.append(r)
            if tied:
                if len(tied) > 1:
                    best_rep = min(
                        tied, key=lambda r: (_first_shared_pos(hashes, j, r),
                                             rep_rank[r]))
                else:
                    best_rep = tied[0]
        if best_rep != -1:
            members[best_rep].append(j)
        else:
            rep_rank[j] = len(rep_order)
            rep_order.append(j)
            members[j] = []
            is_rep[j] = True

    order = np.arange(n, dtype=np.int64)
    clusters = [[r] + members[r] for r in rep_order]
    return GreedyResult(clusters=clusters, representatives=list(rep_order),
                        order=order)


# Source: rabbittclust_tpu/ops/greedy_device.py::_greedy_filter_fn
def greedy_filter_plain(x_all, batch_idx, rep_idx, coll, sizes, jmin_num,
                        jmin_den, c_min, radio_f, is_containment, cap,
                        triangular=False) -> torch.Tensor:
    """Plain K6: the fused int32 [count, flat_idx (cap)] of one batch's
    candidate (batch, rep) pairs, flat = b_local * R + r_local (R =
    len(rep_idx)), -1 padded, as the JAX program returns it.  ``batch_idx``
    and ``rep_idx`` are int32 tensors on ``x_all``'s device; pad slots point
    at a zero-size genome, which the size > 0 check masks out.
    ``triangular`` keeps column position < row position."""
    f32 = torch.float32
    dev = x_all.device
    bi, ri = batch_idx.long(), rep_idx.long()
    xb = unpack_bits(x_all[bi])
    xr = unpack_bits(x_all[ri])
    shared = (xb @ xr.T).to(torch.int32)
    sb, sr, cb, cr = sizes[bi], sizes[ri], coll[bi], coll[ri]
    sb_f = sb[:, None].to(f32)
    sr_f = sr[None, :].to(f32)
    num, den, cm, rf = (torch.tensor(float(v), dtype=f32, device=dev)
                        for v in (jmin_num, jmin_den, c_min, radio_f))
    # float32 bound with a -1 safety margin (ops/bitmap.py::tile_mask_plain)
    if is_containment:
        common_min = torch.floor(cm * torch.minimum(sb_f, sr_f)).to(
            torch.int32) - 1
    else:
        common_min = torch.floor(num * (sb_f + sr_f) / den).to(
            torch.int32) - 1
    thresh = common_min - torch.minimum(cb[:, None], cr[None, :])
    # the size window in float with +1 slack; containment has no size-ratio
    # implication, only nonzero sizes
    mn_i = torch.minimum(sb_f, sr_f)
    mx_i = torch.maximum(sb_f, sr_f)
    if is_containment:
        ratio_ok = mn_i > 0
    else:
        ratio_ok = (mn_i > 0) & (mx_i <= rf * mn_i + 1.0)
    mask = (shared >= thresh) & ratio_ok
    if triangular:
        b, r = mask.shape
        mask &= (torch.arange(r, device=dev)[None, :]
                 < torch.arange(b, device=dev)[:, None])
    count, flat_idx = compact_mask_two_level_plain(mask, cap, cap)
    return torch.cat([count.view(1), flat_idx])


def greedy_filter(x_all, batch_idx, rep_idx, coll, sizes, jmin_num,
                  jmin_den, c_min, radio_f, is_containment, cap,
                  triangular=False) -> torch.Tensor:
    """K6: ``greedy_filter_plain``'s fused buffer.  ``x_all`` (n, bits // 8)
    uint8, ``coll`` and ``sizes`` (n,) int32 are resident; ``batch_idx`` and
    ``rep_idx`` are host int arrays of genomes in [0, n).  On the card the
    two index lists go up in one copy and one C call
    (``rtc_greedy_filter``) queues K1's gathered form, which writes the
    (B, R) mask packed and its count into ``out[0]``, then K3's row form,
    which writes the first ``cap`` set positions in row-major order: no
    host synchronisation."""
    batch_idx = np.asarray(batch_idx, dtype=np.int64).reshape(-1)
    rep_idx = np.asarray(rep_idx, dtype=np.int64).reshape(-1)
    n = x_all.shape[0]
    b, r = len(batch_idx), len(rep_idx)
    for name, idx in (("batch_idx", batch_idx), ("rep_idx", rep_idx)):
        if len(idx) and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"{name} outside the {n} resident genomes")
    if x_all.device.type == "cpu":
        return greedy_filter_plain(
            x_all, torch.from_numpy(batch_idx).to(torch.int32),
            torch.from_numpy(rep_idx).to(torch.int32), coll, sizes,
            jmin_num, jmin_den, c_min, radio_f, is_containment, cap,
            triangular)
    if x_all.device.type != "cuda":
        raise ValueError(f"signatures on {x_all.device}: expected cuda or "
                         "cpu")
    _check_signatures(x_all, coll, sizes, "greedy", x_all.device)
    dev = x_all.device
    if b == 0 or r == 0:
        out = torch.full((1 + cap,), -1, dtype=torch.int32, device=dev)
        out[0] = 0
        return out
    row_words = 4 * -(-r // BLOCK)  # whole 16-byte chunks a row
    _check_flat_range(b, 32 * row_words)
    out = torch.empty((1 + cap,), dtype=torch.int32, device=dev)
    packs = torch.empty((b, row_words), dtype=torch.int32, device=dev)
    gather = _upload(np.concatenate([batch_idx, rep_idx]), dev)
    from ..kernels._build import load_kernels
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch_k3(lib.rtc_greedy_filter, dev,
                  -(-b * row_words // MASK_COMPACT_SEG), x_all.data_ptr(),
                  x_all.shape[1] // 8, coll.data_ptr(), sizes.data_ptr(),
                  gather.data_ptr(), tile_geometry(dev).data_ptr(), b, r,
                  row_words,
                  *(ctypes.c_float(float(v))
                    for v in (jmin_num, jmin_den, c_min, radio_f)),
                  int(bool(is_containment)), int(bool(triangular)),
                  packs.data_ptr(), None, cap, out.data_ptr(), stream)
    LAUNCHES["greedy_filter"] += 1
    return out


# Source: rabbittclust_tpu/ops/greedy_device.py::greedy_cluster_device
def greedy_cluster_device(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    batch_size: int = 2048,
    presorted: bool = False,
    is_containment: bool = False,
    bits: int = 8192,
    conflict: str = "serial",
    device: Optional[torch.device] = None,
    stats: Optional[dict] = None,
) -> GreedyResult:
    """Greedy clustering with device candidate generation.

    ``conflict`` selects the in-batch semantics:
      * "serial" (default): BIT-EXACT vs the reference's default serial
        algorithm (greedy.cpp:566-899) including exact-similarity ties,
        which resolve to the first-touched rep of the index probe (minimal
        (first-shared-hash position, rep creation rank)).  Candidates come
        from ONE triangular all-pairs sweep with lazy host verify;
        ``batch_size`` is not used.  ``RTC_GREEDY_DEVICE=batchloop``, the
        JAX package's legacy per-batch loop, runs the sweep here (both give
        the same result);
      * "batched": bit-exact match of cluster.greedy.greedy_cluster_batched
        at the same batch_size (the reference's experimental batched
        variant: batch members never match reps created within their own
        batch); each batch's candidates come from K6 (``greedy_filter``).

    ``stats``, when given, receives ``sweep_s`` (the device filter and its
    pulls) and ``replay_s`` (the host's verify and decisions)."""
    if conflict not in ("serial", "batched"):
        raise ValueError(f"conflict={conflict!r}: 'serial' or 'batched'")
    if conflict == "batched":
        return _greedy_batched(hashes, threshold, kmer_size, batch_size,
                               presorted, is_containment, bits, device,
                               stats)
    if os.environ.get("RTC_GREEDY_DEVICE") == "batchloop":
        print("-----note: RTC_GREEDY_DEVICE=batchloop (the legacy per-batch "
              "loop) is not ported; running the single sweep, which gives "
              "the same clusters", file=sys.stderr)
    n = len(hashes)
    if n == 0:
        return GreedyResult([], [], np.empty(0, dtype=np.int64))
    if presorted:
        order = np.arange(n, dtype=np.int64)
        inv = list(hashes)
    else:
        sizes0 = np.array([len(h) for h in hashes], dtype=np.int64)
        order = np.lexsort((np.arange(n), -sizes0))
        inv = [hashes[i] for i in order]

    sizes = np.array([len(h) for h in inv], dtype=np.int64)
    rep_order, members = _greedy_serial_sweep(
        inv, sizes, threshold, kmer_size, is_containment, bits,
        device=device, stats=stats)
    clusters = [[int(order[r])] + [int(order[m]) for m in members[r]]
                for r in rep_order]
    reps_orig = [int(order[r]) for r in rep_order]
    return GreedyResult(clusters=clusters, representatives=reps_orig,
                        order=order)


# Source: rabbittclust_tpu/ops/greedy_device.py::greedy_cluster_device (the
# batched branch)
def _greedy_batched(hashes, threshold, kmer_size, batch_size, presorted,
                    is_containment, bits, device, stats):
    from ..device import resolve_device
    device = resolve_device(device)
    clock = time.perf_counter
    st = {} if stats is None else stats
    st["sweep_s"] = st["replay_s"] = 0.0
    n = len(hashes)
    if n == 0:
        return GreedyResult([], [], np.empty(0, dtype=np.int64))
    t_all = clock()
    if presorted:
        order = np.arange(n, dtype=np.int64)
        inv = list(hashes)
    else:
        sizes0 = np.array([len(h) for h in hashes], dtype=np.int64)
        order = np.lexsort((np.arange(n), -sizes0))
        inv = [hashes[i] for i in order]

    xp, coll = pack_bitmaps_packed(inv, bits=bits, pad_n_to=128)
    n_pad = xp.shape[0]
    pad_slot = n_pad - 1 if n < n_pad else n_pad  # zero-size row for padding
    if n == n_pad:  # no spare padded row: append one
        xp = np.vstack([xp, np.zeros((1, xp.shape[1]), dtype=np.uint8)])
        coll = np.r_[coll, np.int32(0)]
        pad_slot = n_pad
    sizes_pad = np.zeros(xp.shape[0], dtype=np.int32)
    sizes = np.array([len(h) for h in inv], dtype=np.int64)
    sizes_pad[:n] = sizes

    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    radio_f = 2.0 * math.exp(threshold * kmer_size) - 1.0
    scalars = (np.float32(j_min), np.float32(1.0 + j_min), np.float32(c_min),
               np.float32(radio_f))

    xd = _to_device(xp, device)
    cd = _to_device(coll, device)
    sd = _to_device(sizes_pad, device)
    csr = CsrSketches(inv)

    rep_order: List[int] = [0]
    members = {0: []}
    rep_cap = 1024
    cap = max(1 << 18, batch_size * 64)

    def _run_filter(batch_idx, rep_idx):
        nonlocal cap
        t0 = clock()
        while True:
            fused = greedy_filter(xd, batch_idx, rep_idx, cd, sd, *scalars,
                                  is_containment, cap)
            count = int(fused[0])
            if count <= cap:
                break
            cap *= 4
        flat = fused[1:1 + count].cpu().numpy().astype(np.int64)
        t1 = clock()
        st["sweep_s"] += t1 - t0
        if not count:
            e = np.empty(0, dtype=np.int64)
            return e, e.copy(), e.copy(), np.empty(0, dtype=np.float64)
        bi = batch_idx[flat // len(rep_idx)].astype(np.int64)
        ri = rep_idx[flat % len(rep_idx)].astype(np.int64)
        common = csr.count_common(bi, ri).astype(np.int64)
        if is_containment:
            d = aaf_distance(common, sizes[bi], sizes[ri], kmer_size)
        else:
            d = mash_distance(common, sizes[bi], sizes[ri], kmer_size)
        ok = common > 0
        return bi[ok], ri[ok], common[ok], d[ok]

    for b0 in range(1, n, batch_size):
        b1 = min(b0 + batch_size, n)
        batch_idx = np.full(batch_size, pad_slot, dtype=np.int32)
        batch_idx[:b1 - b0] = np.arange(b0, b1, dtype=np.int32)
        while rep_cap < len(rep_order):
            rep_cap *= 2
        rep_idx = np.full(rep_cap, pad_slot, dtype=np.int32)
        rep_idx[:len(rep_order)] = rep_order
        vs_reps = _run_filter(batch_idx, rep_idx)
        ok = vs_reps[3] <= threshold
        best = {}
        for b, r, dd in zip(vs_reps[0][ok].tolist(),
                            vs_reps[1][ok].tolist(),
                            vs_reps[3][ok].tolist()):
            cur = best.get(b)
            if cur is None or dd < cur[0] or (dd == cur[0] and r < cur[1]):
                best[b] = (dd, r)
        results = [(j,) + best.get(j, (float("inf"), -1))
                   for j in range(b0, b1)]
        # distance-descending conflict resolution (ties: stable order)
        results.sort(key=lambda t: -t[1])
        for j, _d, rep in results:
            if rep != -1:
                members[rep].append(j)
            else:
                rep_order.append(j)
                members[j] = []

    clusters = [[int(order[r])] + [int(order[m]) for m in members[r]]
                for r in rep_order]
    reps_orig = [int(order[r]) for r in rep_order]
    st["replay_s"] = clock() - t_all - st["sweep_s"]
    return GreedyResult(clusters=clusters, representatives=reps_orig,
                        order=order)
