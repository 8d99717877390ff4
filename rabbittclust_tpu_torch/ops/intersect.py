"""Exact pairwise sketch-intersection counts (counterpart of
``rabbittclust_tpu/ops/intersect.py``).

Kernels written by hand for Hopper in ``csrc/pair_counts.cu``, over the
planes' compact form (``ops/pack.py::compact_planes``, built once per
plane set; K4 joins its value-sorted bucket segments by search):

* K4 ``pair_counts_tiles`` — counts for a batch of (rb x rb) tiles of the
  resident planes; replaces the Pallas kernel ``pair_counts_row_pallas``.
* ``pair_mask_tiles`` — the same kernel in its mask mode: the dense
  engine's per-tile candidate counts and bit-packed masks
  (``rabbittclust_tpu/ops/engine.py::_mst_batch_fn``), without the counts
  ever reaching device memory.
* ``pair_stats_tiles`` — the same kernel in its stats mode: one step of
  the mesh's stats ring (``rabbittclust_tpu/parallel/dist_engine.py::
  build_ring_fn``), the float32 Mash distance of every gated pair reduced
  to a count at the threshold and a minimum, the counts kept on chip.
* K5b ``pair_common`` — counts for explicit (ii, jj) pairs; replaces the
  jitted ``_pair_common_fn`` of the JAX engine.

Each wrapper runs its plain torch version only when the planes lie on the
CPU; on a CUDA tensor it launches the kernel or raises.  ``LAUNCHES``
counts kernel launches, so a run can show that it went through them.

Planes are int32 views of the packed uint32 planes (``ops/pack.py``):
equality is bitwise, so the counts are exact set-intersection sizes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .pack import GROUP, WINDOWS, CompactPlanes, compact_of

LAUNCHES = {"pair_counts_tiles": 0, "pair_mask_tiles": 0, "pair_stats_tiles": 0,
            "pair_common": 0}

# the tile kernel's modes (csrc/pair_counts.cu::Mode)
COUNTS, MASK, STATS = 0, 1, 2
# shared memory of the tile kernel's staging ring, both modes: beside a
# block's counts (64 KB) two blocks an SM, beside its mask bits (2 KB)
# four; longer windows cost blocks an SM, shorter ones more barriers
# (the budgets timed on the card are in PERF.md)
STAGE_BUDGET = 48 * 1024
# dynamic shared memory a block may ask for (pair_counts.cu::SMEM_MAX)
_SMEM_MAX = 232448 - 1024


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pair_counts_plain(a0: torch.Tensor, b0: torch.Tensor,
                      a1: Optional[torch.Tensor] = None,
                      b1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a* (GI, W, K), b* (GJ, W, K) -> (GI, GJ) int32; the formulation of
    ``pair_counts_jnp``."""
    gi, w, _ = a0.shape
    acc = torch.zeros((gi, b0.shape[0]), dtype=torch.int32, device=a0.device)
    for r in range(w):
        for s in range(w):
            eq = a0[:, None, r, :] == b0[None, :, s, :]
            if a1 is not None:
                eq &= a1[:, None, r, :] == b1[None, :, s, :]
            acc += eq.sum(-1, dtype=torch.int32)
    return acc


def pair_counts_row(a0: torch.Tensor, b0: torch.Tensor,
                    a1: Optional[torch.Tensor] = None,
                    b1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One row block against all columns, (GI, N) int32 (the counterpart
    of the JAX dispatcher ``pair_counts_row``), on CPU tensors only.  The
    blocks carry no genome ids, so a kernel could not tell which pairs of
    them are a genome against itself (the plain count's diagonal pad
    term): on the card, K4 runs on the resident planes through
    ``pair_counts_tiles``."""
    if a0.device.type != "cpu":
        raise ValueError("pair_counts_row runs on the CPU; on CUDA use "
                         "pair_counts_tiles over the resident planes")
    return pair_counts_plain(a0, b0, a1, b1)


def _pair_counts_tiles_plain(p0, p1, r0s, c0s, valid, rb, cols=None):
    q0, q1 = (p0, p1) if cols is None else cols[:2]
    out = torch.zeros((len(r0s), rb, rb), dtype=torch.int32,
                      device=p0.device)
    for t, (r0, c0, ok) in enumerate(zip(r0s, c0s, valid)):
        if ok:
            out[t] = pair_counts_plain(
                p0[r0:r0 + rb], q0[c0:c0 + rb],
                None if p1 is None else p1[r0:r0 + rb],
                None if p1 is None else q1[c0:c0 + rb])
    return out


def mask_epilogue(counts: torch.Tensor, sizes: torch.Tensor, r0s, c0s,
                  valid, radio: int, start_index: int, n: int, rb: int,
                  sizes_c: Optional[torch.Tensor] = None, tri: bool = True):
    """The mask of ``_mst_batch_fn`` over (batch, rb, rb) counts, in torch:
    ``counts > 0``, the int32 size-ratio gate (none for ``radio`` 0, as in
    the JAX mesh rings), ``j < i`` (with ``tri``), ``i < n`` and
    ``i >= start_index``, valid tiles only; column sizes from ``sizes_c``
    when given.  Returns per-tile candidate counts (batch,) int32 and
    bit-packed masks (batch, rb, rb // 8) uint8."""
    from .bitmap import pack_mask_u8
    dev = counts.device
    origin = _upload(np.stack([np.asarray(x, dtype=np.int64).reshape(-1)
                               for x in (r0s, c0s, valid)]), dev)
    span = torch.arange(rb, dtype=torch.int32, device=dev)
    rows = origin[0][:, None] + span  # (batch, rb) global row ids
    cols = origin[1][:, None] + span
    si = sizes[rows.long()][:, :, None]
    sj = (sizes if sizes_c is None else sizes_c)[cols.long()][:, None, :]
    mn = torch.minimum(si, sj)
    mx = torch.maximum(si, sj)
    m = (counts > 0) & (mn > 0)
    if radio:
        m &= mx <= radio * mn
    if tri:
        m &= cols[:, None, :] < rows[:, :, None]
    m &= ((rows < n) & (rows >= start_index))[:, :, None]
    m &= (origin[2] > 0)[:, None, None]
    return m.sum((1, 2), dtype=torch.int32), pack_mask_u8(m)


def pair_mask_tiles_plain(p0, p1, sizes, r0s, c0s, valid, radio,
                          start_index, n, rb, cols=None, tri=True):
    """The plain counts of every valid tile, then ``mask_epilogue``."""
    counts = _pair_counts_tiles_plain(p0, p1, r0s, c0s, valid, rb, cols)
    return mask_epilogue(counts, sizes, r0s, c0s, valid, radio, start_index,
                         n, rb, None if cols is None else cols[2], tri)


def _check_planes(p0: torch.Tensor, p1: Optional[torch.Tensor]) -> None:
    if p0.device.type != "cuda":
        raise ValueError(f"planes on {p0.device}: expected cuda or cpu")
    if p0.dtype != torch.int32 or p0.dim() != 3 or not p0.is_contiguous():
        raise ValueError("plane0 must be a contiguous (n, W, K) int32 "
                         "tensor")
    if p0.shape[1] % 4 or not 4 <= p0.shape[1] <= 32 or p0.shape[2] % 4:
        raise ValueError(f"unsupported plane shape {tuple(p0.shape)}: "
                         "W % 4 == 0, 4 <= W <= 32, K % 4 == 0")
    if p1 is not None and (p1.shape != p0.shape or p1.dtype != torch.int32
                           or p1.device != p0.device
                           or not p1.is_contiguous()):
        raise ValueError("plane1 must match plane0")


def _upload(x, device: torch.device) -> torch.Tensor:
    """Host int array -> int32 tensor on ``device``.  The source is
    pageable: the asynchronous copy stages it before returning and waits
    for no work queued on the stream (pinning it would allocate page-locked
    memory, which can synchronise the device)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    return t.to(device, non_blocking=True)


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _tiles(p0, r0s, c0s, valid, rb, n_cols=None):
    """The tile origins as int64 arrays, bounds-checked on live tiles
    (columns against ``n_cols`` genomes, by default the rows')."""
    r0s, c0s, valid = (np.asarray(x, dtype=np.int64).reshape(-1)
                       for x in (r0s, c0s, valid))
    if not len(r0s) == len(c0s) == len(valid):
        raise ValueError("r0s, c0s and valid differ in length")
    live = valid != 0
    n_cols = p0.shape[0] if n_cols is None else n_cols
    if live.any() and (min(r0s[live].min(), c0s[live].min()) < 0 or
                       r0s[live].max() + rb > p0.shape[0] or
                       c0s[live].max() + rb > n_cols):
        raise ValueError(f"a tile of {rb} rows leaves the {p0.shape[0]} / "
                         f"{n_cols} packed genomes")
    return r0s, c0s, valid


def tile_config(compact: CompactPlanes, two_plane: bool, mode: int,
                col_compact: Optional[CompactPlanes] = None):
    """(wb, cap, shared bytes) of the tile kernel: the longest bucket
    window whose staging ring fits ``STAGE_BUDGET``, and the ring's
    capacity in entries per side (``csrc/pair_counts.cu::stage_layout``
    computes the same bytes), over the rows' form and the columns'."""
    planes = 2 if two_plane else 1
    acc = GROUP * GROUP // 8 if mode == MASK else GROUP * GROUP * 4
    forms = [compact] if col_compact is None else [compact, col_compact]
    for wb in WINDOWS:
        most = max(f.window_max[wb] for f in forms)
        cap = (most + 31) // 16 * 16  # + 15 of shift
        stage = 2 * cap * (4 * planes + 1) + 2 * ((4 * (wb + 1) + 15)
                                                  // 16 * 16)
        if 2 * stage <= STAGE_BUDGET:
            break
    smem = 2 * stage + acc
    if smem > _SMEM_MAX:
        raise ValueError(f"a bucket of a group holds {compact.window_max[1]}"
                         " entries: the tile kernel cannot stage it")
    return wb, cap, smem


def _launch_tiles(mode, p0, p1, r0s, c0s, valid, rb, out, sizes=None,
                  tile_counts=None, radio=0, start_index=0, n=0, cols=None,
                  tri=True, thr=0.0, nik=0.0):
    """One launch of the tile kernel; ``sizes`` and ``tile_counts`` are
    read and written in the mask and stats modes only, as are ``cols``
    (the column side's planes and sizes) and ``tri``; ``thr`` and ``nik``
    (float32 threshold and -(1/k)) in the stats mode only."""
    _check_planes(p0, p1)
    if cols is not None:
        _check_planes(cols[0], cols[1])
        if (cols[0].shape[1:] != p0.shape[1:] or cols[0].device != p0.device
                or (cols[1] is None) != (p1 is None)):
            raise ValueError("the column planes must match the row planes' "
                             "width, buckets, planes and device")
    if rb % GROUP:
        raise ValueError(f"rb={rb}: must be a multiple of {GROUP}")
    live = valid != 0
    if (r0s[live] % GROUP).any() or (c0s[live] % GROUP).any():
        raise ValueError(f"tile origins must be multiples of {GROUP}")
    if len(r0s) > 65535:
        raise ValueError("at most 65,535 tiles a launch")
    from ..kernels._build import load_kernels
    lib = load_kernels()
    cf = compact_of(p0, p1)
    cc = cf if cols is None else compact_of(cols[0], cols[1])
    wb, cap, _ = tile_config(cf, p1 is not None, mode,
                             None if cols is None else cc)
    sizes_c = sizes if cols is None else cols[2]
    idx = _upload(np.stack([r0s, c0s, live]), p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        _launch(lib.rtc_pair_tiles, cf.g0.data_ptr(),
                (cf.g0 if cf.g1 is None else cf.g1).data_ptr(),
                cf.gid.data_ptr(), cf.goff.data_ptr(), cf.start.data_ptr(),
                cf.padsq.data_ptr(), _ptr(sizes), cc.g0.data_ptr(),
                (cc.g0 if cc.g1 is None else cc.g1).data_ptr(),
                cc.gid.data_ptr(), cc.goff.data_ptr(), cc.start.data_ptr(),
                _ptr(sizes_c), idx[0].data_ptr(), idx[1].data_ptr(),
                idx[2].data_ptr(), _ptr(out), _ptr(tile_counts),
                len(r0s), rb, p0.shape[2], wb, cap, int(p1 is not None),
                mode, radio, start_index, n, int(bool(tri)), float(thr),
                float(nik), stream)


def pair_counts_tiles(p0: torch.Tensor, p1: Optional[torch.Tensor],
                      r0s, c0s, valid, rb: int) -> torch.Tensor:
    """counts[t] = pair counts of rows [r0s[t], +rb) against columns
    [c0s[t], +rb) of the planes (n_pad, W, K): (batch, rb, rb) int32.
    ``r0s``, ``c0s`` and ``valid`` are host int sequences of one length;
    tiles with ``valid[t] == 0`` are not computed (zero on the CPU,
    unwritten on CUDA).  On CUDA, rb and the origins of valid tiles are
    multiples of ``GROUP``."""
    r0s, c0s, valid = _tiles(p0, r0s, c0s, valid, rb)
    if p0.device.type == "cpu":
        return _pair_counts_tiles_plain(p0, p1, r0s, c0s, valid, rb)
    out = torch.empty((len(r0s), rb, rb), dtype=torch.int32,
                      device=p0.device)
    _launch_tiles(COUNTS, p0, p1, r0s, c0s, valid, rb, out)
    LAUNCHES["pair_counts_tiles"] += 1
    return out


def pair_mask_tiles(p0: torch.Tensor, p1: Optional[torch.Tensor],
                    sizes: torch.Tensor, r0s, c0s, valid, radio: int,
                    start_index: int, n: int, rb: int, cols=None,
                    tri: bool = True):
    """The dense engine's batch (``_mst_batch_fn``): per-tile candidate
    counts (batch,) int32 and bit-packed masks (batch, rb, rb // 8) uint8
    of the pairs with a common hash that pass ``mask_epilogue``'s gates.
    ``sizes`` (n_pad,) int32 on the planes' device.  ``cols`` (plane0,
    plane1, sizes) gives the columns their own planes, as a mesh ring step
    reads a visiting shard's; ``tri`` keeps j < i only."""
    n_cols = None if cols is None else cols[0].shape[0]
    r0s, c0s, valid = _tiles(p0, r0s, c0s, valid, rb, n_cols)
    if p0.device.type == "cpu":
        return pair_mask_tiles_plain(p0, p1, sizes, r0s, c0s, valid, radio,
                                     start_index, n, rb, cols, tri)
    for t, m in ((sizes, p0.shape[0]), (None if cols is None else cols[2],
                                        n_cols)):
        if t is not None and (t.dtype != torch.int32 or t.device != p0.device
                              or t.shape != (m,) or not t.is_contiguous()):
            raise ValueError("sizes must be contiguous (n_pad,) int32 "
                             "tensors on the planes' device")
    cnts = torch.zeros(len(r0s), dtype=torch.int32, device=p0.device)
    packs = torch.zeros((len(r0s), rb, rb // 8), dtype=torch.uint8,
                        device=p0.device)
    _launch_tiles(MASK, p0, p1, r0s, c0s, valid, rb, packs, sizes, cnts,
                  radio, start_index, n, cols, tri)
    LAUNCHES["pair_mask_tiles"] += 1
    return cnts, packs


def stats_epilogue(counts: torch.Tensor, s_rows: torch.Tensor,
                   s_cols: torch.Tensor, ok: torch.Tensor, radio: int,
                   threshold: float, kmer_size: int) -> torch.Tensor:
    """``build_ring_fn``'s step after its counts, in float32 and in JAX's
    order of operations: the gates ``counts > 0``, ``min > 0`` and
    ``max <= radio * min`` (none for ``radio`` 0) and'ed with ``ok``;
    ``j = common / max(denom, 1)`` where ``denom = s0 + s1 - common > 0``,
    else 0; ``d`` 0 where ``j >= 1``, 1 where ``j <= 0``, else
    ``-(1/k) * log(2j / (1 + j))``.  Returns (2,) int32: the count of
    gated pairs with ``d <= threshold`` and the float32 bits of
    ``min(where(ok, d, 1.0))`` (-0.0 read as +0.0, as the kernel keeps
    it).  ``s_rows`` (rows, 1) and ``s_cols`` (1, cols) int sizes."""
    f32 = torch.float32
    s0, s1 = s_rows.to(f32), s_cols.to(f32)
    mn, mx = torch.minimum(s0, s1), torch.maximum(s0, s1)
    ok = ok & (counts > 0) & (mn > 0)
    if radio:
        ok &= mx <= radio * mn
    common = counts.to(f32)
    denom = s0 + s1 - common
    one, zero = torch.ones((), dtype=f32), torch.zeros((), dtype=f32)
    j = torch.where(denom > 0, common / torch.clamp(denom, min=1.0), zero)
    nik = torch.tensor(np.float32(-(1.0 / kmer_size)))
    d = torch.where(j >= 1.0, zero, torch.where(
        j <= 0.0, one, nik * torch.log(2.0 * j / (1.0 + j))))
    count = (ok & (d <= torch.tensor(np.float32(threshold)))).sum(
        dtype=torch.int32)
    low = torch.where(ok, d, one).min() + 0.0
    return torch.stack([count, low.view(torch.int32)])


def pair_stats_tiles_plain(p0, sizes, r0s, c0s, valid, radio, threshold,
                           kmer_size, rb, cols=None, tri=True):
    """The plain counts of every valid tile (plane 0), then
    ``stats_epilogue`` with ``j < i`` (``tri``) on the tile positions,
    summed and minimised over the tiles."""
    q0, s_c = (p0, sizes) if cols is None else (cols[0], cols[1])
    dev = p0.device
    out = torch.tensor([0, int(np.float32(1.0).view(np.int32))],
                       dtype=torch.int32, device=dev)
    span = torch.arange(rb, device=dev)
    for r0, c0, live in zip(r0s, c0s, valid):
        if not live:
            continue
        counts = torch.cat([pair_counts_plain(p0[r:min(r + 512, r0 + rb)],
                                              q0[c0:c0 + rb])
                            for r in range(r0, r0 + rb, 512)])
        ok = (c0 + span)[None, :] < (r0 + span)[:, None] if tri else \
            torch.ones((rb, rb), dtype=torch.bool, device=dev)
        st = stats_epilogue(counts, sizes[r0:r0 + rb, None],
                            s_c[None, c0:c0 + rb], ok, radio, threshold,
                            kmer_size)
        out = torch.stack([out[0] + st[0], torch.minimum(out[1], st[1])])
    return out


def pair_stats_tiles(p0: torch.Tensor, sizes: torch.Tensor, r0s, c0s, valid,
                     radio: int, threshold: float, kmer_size: int, rb: int,
                     cols=None, tri: bool = True) -> torch.Tensor:
    """One step of the stats ring over plane 0 (a 32-bit pack's plane:
    the compact form takes a value with its top bit set for a pad): for
    the pairs of each valid tile that pass ``stats_epilogue``'s gates
    (and ``j < i`` with ``tri``), the count at ``threshold`` and the
    minimum distance, as (2,) int32 [count, float32 bits of the minimum]
    on the planes' device.  ``cols`` (plane0, sizes) gives the columns
    their own planes (a visiting shard's).  On the card K4's stats mode:
    the counts stay on chip and each block adds its count and minimum to
    the two words with atomics."""
    n_cols = None if cols is None else cols[0].shape[0]
    r0s, c0s, valid = _tiles(p0, r0s, c0s, valid, rb, n_cols)
    if p0.device.type == "cpu":
        return pair_stats_tiles_plain(p0, sizes, r0s, c0s, valid, radio,
                                      threshold, kmer_size, rb, cols, tri)
    for t, m in ((sizes, p0.shape[0]), (None if cols is None else cols[1],
                                        n_cols)):
        if t is not None and (t.dtype != torch.int32 or t.device != p0.device
                              or t.shape != (m,) or not t.is_contiguous()):
            raise ValueError("sizes must be contiguous (n_pad,) int32 "
                             "tensors on the planes' device")
    stats = torch.tensor([0, int(np.float32(1.0).view(np.int32))],
                         dtype=torch.int32, device=p0.device)
    _launch_tiles(STATS, p0, None, r0s, c0s, valid, rb, None, sizes, stats,
                  radio, 0, p0.shape[0],
                  None if cols is None else (cols[0], None, cols[1]), tri,
                  np.float32(threshold), np.float32(-(1.0 / kmer_size)))
    LAUNCHES["pair_stats_tiles"] += 1
    return stats


def stats_division(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` of two contiguous float32 tensors of one shape by the
    division K4's stats epilogue runs on the card (``csrc/pair_counts.cu::
    div_rn_normal``, not IEEE's sequence in full), to hold it to IEEE
    division over the epilogue's operands; on the CPU, torch's division."""
    if a.device.type == "cpu":
        return a / b
    if (a.dtype != torch.float32 or b.dtype != torch.float32
            or a.shape != b.shape or b.device != a.device
            or not (a.is_contiguous() and b.is_contiguous())):
        raise ValueError("a and b must be contiguous float32 tensors of "
                         "one shape on one device")
    from ..kernels._build import load_kernels
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        _launch(load_kernels().rtc_div_rn_normal, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), a.numel(),
                torch.cuda.current_stream(a.device).cuda_stream)
    return out


def pair_common_plain(p0: torch.Tensor, p1: Optional[torch.Tensor],
                      ii: torch.Tensor, jj: torch.Tensor,
                      chunk: int = 2048, cols=None) -> torch.Tensor:
    """Exact common counts for explicit pairs (int tensors on the planes'
    device), (q,) int32; the chunked gather of ``_pair_common_fn``; ``jj``
    indexes ``cols`` (plane0, plane1) when given."""
    q0, q1 = (p0, p1) if cols is None else cols[:2]
    out = []
    for s in range(0, ii.shape[0], chunk):
        ic, jc = ii[s:s + chunk].long(), jj[s:s + chunk].long()
        eq = p0[ic][:, :, None, :] == q0[jc][:, None, :, :]
        if p1 is not None:
            eq &= p1[ic][:, :, None, :] == q1[jc][:, None, :, :]
        out.append(eq.sum((1, 2, 3), dtype=torch.int32))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=p0.device)
    return torch.cat(out)


def pair_common(p0: torch.Tensor, p1: Optional[torch.Tensor],
                ii, jj) -> torch.Tensor:
    """|A_ii[p] ∩ A_jj[p]| for every pair p of the host int arrays
    ``ii``, ``jj``: (q,) int32 on the planes' device."""
    ii = np.asarray(ii, dtype=np.int64).reshape(-1)
    jj = np.asarray(jj, dtype=np.int64).reshape(-1)
    if ii.shape != jj.shape:
        raise ValueError("ii and jj differ in length")
    if len(ii) and (min(ii.min(), jj.min()) < 0 or
                    max(ii.max(), jj.max()) >= p0.shape[0]):
        raise ValueError("pair index outside the packed genomes")
    if p0.device.type == "cpu":
        return pair_common_plain(p0, p1, torch.from_numpy(ii),
                                 torch.from_numpy(jj))
    return pair_common_launch(p0, p1, _upload(np.stack([ii, jj]), p0.device))


def pair_common_launch(p0: torch.Tensor, p1: Optional[torch.Tensor],
                       pairs: torch.Tensor, cols=None) -> torch.Tensor:
    """``pair_common`` for a (2, q) int32 tensor of pair indices already on
    the planes' device, each in range (unchecked: what ``pair_common``
    checks and uploads): (q,) int32.  ``cols`` (plane0, plane1), when
    given, are the planes the second row indexes (a visiting shard's)."""
    if p0.device.type == "cpu":
        return pair_common_plain(p0, p1, pairs[0], pairs[1], cols=cols)
    _check_planes(p0, p1)
    if cols is not None:
        _check_planes(cols[0], cols[1])
        if (cols[0].shape[1:] != p0.shape[1:] or cols[0].device != p0.device
                or (cols[1] is None) != (p1 is None)):
            raise ValueError("the column planes must match the row planes' "
                             "width, buckets, planes and device")
    if pairs.dtype != torch.int32 or pairs.dim() != 2 or \
            pairs.shape[0] != 2 or not pairs.is_contiguous() or \
            pairs.device != p0.device:
        raise ValueError("pairs must be a contiguous (2, q) int32 tensor on "
                         "the planes' device")
    from ..kernels._build import load_kernels
    lib = load_kernels()
    cf = compact_of(p0, p1)
    cb = cf if cols is None else compact_of(cols[0], cols[1])
    q = pairs.shape[1]
    out = torch.empty(q, dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        _launch(lib.rtc_pair_common, cf.v0.data_ptr(),
                (cf.v0 if cf.v1 is None else cf.v1).data_ptr(),
                cf.occ.data_ptr(), cf.start.data_ptr(), cf.padsq.data_ptr(),
                cb.v0.data_ptr(),
                (cb.v0 if cb.v1 is None else cb.v1).data_ptr(),
                cb.occ.data_ptr(), cb.start.data_ptr(), pairs[0].data_ptr(),
                pairs[1].data_ptr(), out.data_ptr(), q, p0.shape[2],
                int(p1 is not None), stream)
    LAUNCHES["pair_common"] += 1
    return out
