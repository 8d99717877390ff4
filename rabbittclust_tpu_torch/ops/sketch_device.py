"""Device KSSD sketching on the GPU (counterpart of
``rabbittclust_tpu/ops/sketch_device.py``): kernel K7.

All records of all genomes ride one flat code stream (``BASE_MAP`` codes,
k - 1 invalid codes between records and between genomes, so no window
spans a boundary).  The stream is cut into dispatch windows of
``s_rows * chunk`` positions that overlap by k - 1 codes, the last one
padded with invalid codes; window w + 1 is dispatched before window w is
pulled.  Each window yields its kept windows' (hash, position) in position
order; positions map back to genomes by a ``searchsorted`` over the
genomes' start offsets, and each genome's hashes are deduplicated with
``np.unique``.  The sketches equal the native sketcher's bit for bit.

* ``sketch_window`` — K7 over one window (``csrc/kssd_sketch.cu``); the
  kernel counts the kept windows before it scatters them, so it needs no
  capacity and no regrow.  ``sketch_window_plain`` is its plain torch
  version: ``_chunk_kernel``'s formulation (k shifted ORs, in int64) over
  rows of ``chunk`` positions, as the JAX program's ``lax.scan`` rows,
  followed by an ordered ``nonzero``.
* ``keep_bitmap`` — the set of dimensions that keep a window (``0 <=
  table[d] < dim_end``) as a bitmap with a coarse level, built once per
  (table, dim_end) and kept on the table tensor; K7's keep test reads it
  in place of the table.  ``keep_bitmap_plain`` is its plain version.

On a CPU device everything runs the plain version; on a CUDA device the
wrapper launches K7 or raises.  ``LAUNCHES`` counts K7's launches, the
window's and the bitmap's build.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..sketch.kssd import BASE_MAP, KssdParams, get_shuffle_table
from .intersect import _launch

# default chunk: positions per row (the JAX scan row)
CHUNK = 1 << 20
# default rows per dispatch window (positions = S_ROWS * CHUNK)
S_ROWS = 16
# positions of a K7 span and threads a block (csrc/kssd_sketch.cu SPAN,
# THREADS); the wrapper sizes K7's scratch with them
K7_SPAN = 8192
K7_THREADS = 256
# dimensions a bit of the keep bitmap's coarse level covers
# (csrc/kssd_sketch.cu COARSE_SHIFT)
COARSE_DIMS = 256

LAUNCHES = {"kssd_sketch": 0, "kssd_keep_bitmap": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _s64(v: int) -> int:
    """The int64 with the bit pattern of the uint64 ``v``."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's is arithmetic)."""
    return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)


def _shifts(p: KssdParams) -> Tuple[int, int, int]:
    """(hol2, shift1, drshift) of the reference's mask algebra."""
    hol2 = 2 * (p.half_k - p.half_subk)
    return hol2, 2 * p.kmer_size - 4 * (p.half_k - p.half_subk), \
        4 * p.drlevel


def _pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> int32 words, bit b of word w = flags[32 w + b]."""
    f = torch.nn.functional.pad(flags.to(torch.uint8),
                                (0, -flags.numel() % 32)).view(-1, 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=f.device)
    return (f << shifts).sum(1, dtype=torch.uint8).view(torch.int32)


def keep_bitmap_plain(table: torch.Tensor, dim_end: int) -> torch.Tensor:
    """Plain keep bitmap: int32 words, ceil(n / 32) fine ones (bit d set
    iff 0 <= table[d] < dim_end, n = table.numel()), then ceil(n / 8192)
    coarse ones (bit c set iff any of dimensions [256 c, +256) is)."""
    keep = (table >= 0) & (table < dim_end)
    coarse = torch.nn.functional.pad(
        keep, (0, -keep.numel() % COARSE_DIMS)).view(-1, COARSE_DIMS).any(1)
    return torch.cat([_pack_bits(keep), _pack_bits(coarse)])


def _kept_on(table: torch.Tensor, key, build) -> torch.Tensor:
    """``build()``, kept on ``table`` under ``key`` and built again only
    when the table was modified in place."""
    kept = getattr(table, "_rtc_keep", None)
    if kept is None or kept[0] != table._version:
        kept = table._rtc_keep = (table._version, {})
    if key not in kept[1]:
        kept[1][key] = build()
    return kept[1][key]


def keep_bitmap(table: torch.Tensor, dim_end: int) -> torch.Tensor:
    """The keep bitmap of ``table`` for ``dim_end`` (``keep_bitmap_plain``'s
    words), built once and kept on the table: on a CUDA table by one launch
    of K7's bitmap kernel, on a CPU table by the plain version."""
    if table.device.type == "cpu":
        return _kept_on(table, ("plain", dim_end),
                        lambda: keep_bitmap_plain(table, dim_end))
    return _kept_on(table, ("kernel", dim_end),
                    lambda: _keep_bitmap_launch(table, dim_end))


def _keep_bitmap_launch(table: torch.Tensor, dim_end: int) -> torch.Tensor:
    if table.dtype != torch.int32 or not table.is_contiguous() \
            or table.dim() != 1 or not 0 < table.numel() <= 1 << 24:
        raise ValueError("table must be a contiguous 1-D int32 tensor of at "
                         "most 2^24 entries")
    from ..kernels._build import load_kernels
    lib = load_kernels()
    n = table.numel()
    dev = table.device
    out = torch.empty(-(-n // 32) + -(-n // (32 * COARSE_DIMS)),
                      dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.rtc_kssd_keep_bitmap, table.data_ptr(), n, int(dim_end),
                out.data_ptr(), stream)
    LAUNCHES["kssd_keep_bitmap"] += 1
    return out


def _bit(bitmap: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bit ``d`` (int64, >= 0) of the bitmap's fine words, as bool."""
    return ((bitmap[d >> 5] >> (d & 31).to(torch.int32)) & 1).bool()


def _row_dims(c: torch.Tensor, n: int, p: KssdParams):
    """The canonical tuples (int64 bit patterns), their dimensions and
    validity at the ``n`` positions of one row's codes ``c`` (int64, n + k
    - 1 of them): ``_chunk_kernel``'s formulation."""
    k = p.kmer_size
    dev = c.device
    hol2 = _shifts(p)[0]
    sign = torch.tensor(_s64(1 << 63), dtype=torch.int64, device=dev)
    tup = torch.zeros(n, dtype=torch.int64, device=dev)
    rvs = torch.zeros(n, dtype=torch.int64, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for j in range(k):
        cj = c[j:j + n]
        vj = cj >= 0
        valid &= vj
        cc = torch.where(vj, cj, 0)
        tup |= cc << (2 * (k - 1 - j))
        rvs |= torch.where(vj, cc ^ 3, 0) << (2 * j)
    # the canonical tuple: the unsigned minimum (compare with bit 63
    # flipped; a signed min picks the wrong tuple when it is set)
    uni = torch.where((tup ^ sign) < (rvs ^ sign), tup, rvs)
    return uni, _shr(uni & _s64(p.domask), hol2), valid


def sketch_window_plain(codes: torch.Tensor, table: torch.Tensor,
                        p: KssdParams, chunk: int = CHUNK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K7: the kept windows of one dispatch window.

    ``codes`` (n_pos + k - 1,) int8, -1 invalid; ``table`` the int32
    shuffle table on the same device.  Returns (hash int64 holding the
    uint64 bit pattern, position int32) in position order: the first
    ``total`` (hi << 32 | lo, enc) rows of the JAX ``_stream_kernel_fn``.
    A valid window is kept when its dimension's bit is set in the plain
    keep bitmap (kept on the table), and the table's rank is read for the
    kept ones only.  Rows of ``chunk`` positions bound the int64
    temporaries; a row whose codes are all invalid keeps nothing and is
    skipped."""
    k = p.kmer_size
    n_pos = codes.numel() - (k - 1)
    dev = codes.device
    bitmap = _kept_on(table, ("plain", p.dim_end),
                      lambda: keep_bitmap_plain(table, p.dim_end))
    _, shift1, drshift = _shifts(p)
    und0, und1 = _s64(p.undomask0), _s64(p.undomask1)
    hashes, positions = [], []
    for r0 in range(0, max(n_pos, 0), chunk):
        n = min(chunk, n_pos - r0)
        c = codes[r0:r0 + n + k - 1].to(torch.int64)
        if not bool((c >= 0).any()):
            continue
        uni, dim, valid = _row_dims(c, n, p)
        keep = valid & _bit(bitmap, torch.where(valid, dim, 0))
        (idx,) = torch.nonzero(keep, as_tuple=True)
        if not idx.numel():
            continue
        uni = uni[idx]
        pf = table[dim[idx]].to(torch.int64)
        lifted = (uni & und1) << shift1 if shift1 < 64 else 0
        dr = _shr((uni & und0) | lifted, drshift) | pf
        hashes.append(dr)
        positions.append((idx + r0).to(torch.int32))
    if not hashes:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    return torch.cat(hashes), torch.cat(positions)


def _check_window(codes: torch.Tensor, table: torch.Tensor,
                  p: KssdParams) -> int:
    k = p.kmer_size
    if codes.dtype != torch.int8 or codes.dim() != 1 \
            or not codes.is_contiguous() or codes.data_ptr() % 16:
        raise ValueError("codes must be a contiguous, 16-byte aligned 1-D "
                         "int8 tensor")
    if table.dtype != torch.int32 or not table.is_contiguous() \
            or table.device != codes.device \
            or table.numel() != 1 << (4 * p.half_subk):
        raise ValueError(f"table must be the contiguous int32 shuffle table "
                         f"of 16^{p.half_subk} entries on {codes.device}")
    if not 2 <= k <= 32:
        raise ValueError(f"k = {k}: K7 takes 2 <= k <= 32")
    n_pos = codes.numel() - (k - 1)
    if not 0 < n_pos < (1 << 31) - K7_SPAN:
        raise ValueError(f"{n_pos} positions: K7 takes 1 to 2^31 - "
                         f"{K7_SPAN} a window")
    return n_pos


def sketch_window_launch(codes: torch.Tensor, table: torch.Tensor,
                         p: KssdParams
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K7 on one window on the current stream and return without
    waiting: (hash int64 (n_pos,), position int32 (n_pos,), total int32
    (1,)), all on the card; the first ``total`` rows are the kept
    windows."""
    n_pos = _check_window(codes, table, p)
    bitmap = keep_bitmap(table, p.dim_end)
    from ..kernels._build import load_kernels
    lib = load_kernels()
    dev = codes.device
    spans = -(-n_pos // K7_SPAN)
    scratch = torch.empty(spans * (K7_THREADS + 2), dtype=torch.int32,
                          device=dev)
    out_hash = torch.empty(n_pos, dtype=torch.int64, device=dev)
    out_pos = torch.empty(n_pos, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    hol2, shift1, drshift = _shifts(p)
    u64 = ctypes.c_uint64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.rtc_kssd_sketch, codes.data_ptr(), n_pos, p.kmer_size,
                bitmap.data_ptr(), table.numel(), table.data_ptr(),
                u64(p.tupmask), u64(p.domask), u64(p.undomask0),
                u64(p.undomask1), hol2, shift1, drshift, scratch.data_ptr(),
                out_hash.data_ptr(), out_pos.data_ptr(), total.data_ptr(),
                stream)
    LAUNCHES["kssd_sketch"] += 1
    return out_hash, out_pos, total


def sketch_window(codes: torch.Tensor, table: torch.Tensor, p: KssdParams
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: ``sketch_window_plain``'s result.  On a CUDA tensor it launches
    the kernel and waits for the total; on a CPU tensor it is the plain
    version."""
    if codes.device.type == "cpu":
        return sketch_window_plain(codes, table, p)
    if codes.device.type != "cuda":
        raise ValueError(f"codes on {codes.device}: expected cuda or cpu")
    out_hash, out_pos, total = sketch_window_launch(codes, table, p)
    n = int(total.item())
    return out_hash[:n], out_pos[:n]


@lru_cache(maxsize=4)
def _device_table(half_subk: int, device: torch.device) -> torch.Tensor:
    """The shuffle table, uploaded once per ``half_subk`` and device and
    kept resident (64 MB at half_subk 6), with its keep bitmaps
    (``keep_bitmap``) on it."""
    return torch.from_numpy(get_shuffle_table(half_subk)).to(device)


# Source: rabbittclust_tpu/ops/sketch_device.py::_encode_codes
def _encode_codes(seq: bytes) -> np.ndarray:
    return BASE_MAP[np.frombuffer(seq, dtype=np.uint8)].astype(np.int8)


class _CardWindows:
    """Dispatch and pull of K7 windows on the card.  The window's codes go
    through one of two page-locked buffers and up on a side stream, so a
    window's upload overlaps the previous window's kernel; the pull of a
    window's kept rows waits on that window's event alone, never on the
    window dispatched after it."""

    def __init__(self, n_codes: int, table: torch.Tensor, p: KssdParams,
                 device: torch.device):
        self.table, self.p, self.device = table, p, device
        self.host = [torch.empty(n_codes, dtype=torch.int8, pin_memory=True)
                     for _ in range(2)]
        self.turn = 0
        self.side = torch.cuda.Stream(device)

    def dispatch(self, window: np.ndarray):
        # buffer turn was last read by the upload of the window before the
        # previous one, which the caller collected before this dispatch
        host = self.host[self.turn]
        self.turn ^= 1
        host.numpy()[:] = window
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.side):
            codes = host.to(self.device, non_blocking=True)
            uploaded = torch.cuda.Event()
            uploaded.record(self.side)
        main.wait_event(uploaded)
        out_hash, out_pos, total = sketch_window_launch(codes, self.table,
                                                        self.p)
        total_host = torch.empty(1, dtype=torch.int32, pin_memory=True)
        total_host.copy_(total, non_blocking=True)
        done = torch.cuda.Event()
        done.record(main)
        return codes, out_hash, out_pos, total_host, done

    def collect(self, pending) -> Tuple[np.ndarray, np.ndarray]:
        _codes, out_hash, out_pos, total_host, done = pending
        done.synchronize()
        n = int(total_host[0])
        with torch.cuda.stream(self.side):
            self.side.wait_event(done)
            hashes = torch.empty(n, dtype=torch.int64, pin_memory=True)
            positions = torch.empty(n, dtype=torch.int32, pin_memory=True)
            hashes.copy_(out_hash[:n], non_blocking=True)
            positions.copy_(out_pos[:n], non_blocking=True)
        self.side.synchronize()
        return hashes.numpy(), positions.numpy()


# Source: rabbittclust_tpu/ops/sketch_device.py::_sketch_stream (without the
# per-row cap, its regrow loop and the pull quantum: K7 counts before it
# scatters)
def _sketch_stream(records: Iterable[Tuple[int, np.ndarray]],
                   p: KssdParams, chunk: int = CHUNK,
                   s_rows: int = S_ROWS,
                   device: Optional[torch.device] = None
                   ) -> Dict[int, np.ndarray]:
    """Core stream engine: records yields (genome_id, codes int8) in
    nondecreasing genome order; returns {genome_id: kept hashes uint64,
    position order, NON-deduplicated}.  Genomes with no kept windows are
    absent from the result."""
    device = resolve_device(device)
    k = p.kmer_size
    D = s_rows * chunk  # positions per dispatch window
    W = D + k - 1  # codes per dispatch window
    table = _device_table(p.half_subk, device)
    card = _CardWindows(W, table, p, device) if device.type == "cuda" \
        else None
    sep = np.full(k - 1, -1, dtype=np.int8)

    parts: List[np.ndarray] = []  # unconsumed stream codes
    avail = 0
    base = 0  # global position of parts[0][0]
    starts: List[int] = []  # global start offset per genome (ascending)
    gids: List[int] = []
    last_gid = None
    out: Dict[int, List[np.ndarray]] = {}
    pending = None  # (window_base, card pending or the plain result)

    def dispatch(window: np.ndarray, wbase: int):
        if card is not None:
            return wbase, card.dispatch(window)
        h, pos = sketch_window_plain(torch.from_numpy(window), table, p,
                                     chunk)
        return wbase, (h.numpy(), pos.numpy())

    def collect(pend):
        wbase, res = pend
        h, enc = card.collect(res) if card is not None else res
        if not len(h):
            return
        hashes = h.view(np.uint64)
        pos = wbase + enc.astype(np.int64)
        # positions ascend and genomes are stream-ordered, so genome ids
        # are nondecreasing: one searchsorted + boundary split attributes
        # every kept window
        g_of = np.searchsorted(np.asarray(starts, dtype=np.int64), pos,
                               side="right") - 1
        cut = np.flatnonzero(np.diff(g_of)) + 1
        bounds = np.r_[0, cut, len(pos)]
        for a, b in zip(bounds[:-1], bounds[1:]):
            gid = gids[int(g_of[a])]
            out.setdefault(gid, []).append(hashes[a:b])

    def flush(final: bool = False):
        nonlocal parts, avail, base, pending
        if not parts:
            return
        stream = np.concatenate(parts) if len(parts) > 1 else parts[0]
        while len(stream) >= W or (final and len(stream)):
            window = stream[:W]
            if len(window) < W:
                window = np.concatenate(
                    [window, np.full(W - len(window), -1, dtype=np.int8)])
            nxt = dispatch(window, base)  # pipeline: dispatch next...
            if pending is not None:
                collect(pending)  # ...before pulling the previous window
            pending = nxt
            stream = stream[D:]
            base += D
        parts = [stream] if len(stream) else []
        avail = len(stream)

    for gid, codes in records:
        if gid != last_gid:
            if last_gid is not None:
                parts.append(sep)
                avail += len(sep)
            starts.append(base + avail)
            gids.append(gid)
            last_gid = gid
        else:
            parts.append(sep)  # record boundary within a genome
            avail += len(sep)
        parts.append(codes)
        avail += len(codes)
        if avail >= W:
            flush()
    if avail:
        flush(final=True)
    if pending is not None:
        collect(pending)
    return {g: np.concatenate(v) for g, v in out.items()}


# Source: rabbittclust_tpu/ops/sketch_device.py::device_kmer_hashes
def device_kmer_hashes(seq: bytes, p: KssdParams, chunk: int = CHUNK,
                       device: Optional[torch.device] = None) -> np.ndarray:
    """All kept (non-deduplicated) KSSD hashes of one sequence as uint64 —
    the device twin of sketch.kssd.kssd_kmer_hashes_numpy, bit-identical."""
    if len(seq) < p.kmer_size:
        return np.empty(0, dtype=np.uint64)
    res = _sketch_stream([(0, _encode_codes(seq))], p, chunk=chunk,
                         s_rows=min(S_ROWS, max(1, -(-len(seq) // chunk))),
                         device=device)
    return res.get(0, np.empty(0, dtype=np.uint64))


# Source: rabbittclust_tpu/ops/sketch_device.py::sketch_kssd_device
def sketch_kssd_device(genomes: List[List[bytes]], p: KssdParams,
                       chunk: int = CHUNK, s_rows: int = S_ROWS,
                       device: Optional[torch.device] = None
                       ) -> List[np.ndarray]:
    """Device-sketch a batch of genomes (each = list of record sequences).

    All genomes ride ONE code stream (records within and across genomes
    separated by k-1 invalid codes), so the whole batch costs
    ceil(total_bases / (s_rows*chunk)) pipelined dispatches.  Returns
    per-genome sorted deduplicated hash arrays (uint64 if p.use64 else
    uint32) bit-identical to the native sketcher."""
    def gen():
        for gid, records in enumerate(genomes):
            for s in records:
                yield gid, _encode_codes(s)

    res = _sketch_stream(gen(), p, chunk=chunk, s_rows=s_rows,
                         device=device)
    empty = np.empty(0, dtype=np.uint64)
    out = []
    for gid in range(len(genomes)):
        h = np.unique(res.get(gid, empty))
        out.append(h if p.use64 else h.astype(np.uint32))
    return out


# Source: rabbittclust_tpu/ops/sketch_device.py::sketch_files_kssd_device
def sketch_files_kssd_device(files, min_len: int, kmer_size: int,
                             drlevel: int, chunk: int = CHUNK,
                             s_rows: int = S_ROWS,
                             device: Optional[torch.device] = None
                             ) -> Tuple[object, KssdParams]:
    """Device-sketch a list of FASTA(.gz) files — drop-in equivalent of
    sketch.kssd.sketch_files_kssd (same SketchSet contents).

    Files stream through the SHARED code stream (one pipelined dispatch
    per s_rows*chunk bases across file boundaries); host memory is
    bounded by one dispatch window plus one file's records."""
    from ..io.fasta import read_fasta
    from ..sketch.base import SketchSet

    p = KssdParams.from_kmer_size(kmer_size, drlevel)
    ss = SketchSet("kssd", p, True, p.use64)
    metas = []  # (file, name, comment, seq0_len, total, num_seqs)

    def gen():
        for f in files:
            records = list(read_fasta(f))
            total = sum(len(s) for _, _, s in records)
            if total < min_len or not records:
                continue
            gid = len(metas)
            name, comment, seq0 = records[0]
            metas.append((f, name or "noName", comment or "noName",
                          len(seq0), total, len(records)))
            for _, _, s in records:
                yield gid, _encode_codes(s)

    res = _sketch_stream(gen(), p, chunk=chunk, s_rows=s_rows,
                         device=device)
    empty = np.empty(0, dtype=np.uint64)
    for gid, (f, name, comment, s0, total, nseq) in enumerate(metas):
        h = np.unique(res.get(gid, empty))
        ss.append_genome(
            file_name=f, name=name, comment=comment, seq0_len=s0,
            total_len=total, num_seqs=nseq,
            hashes=h if p.use64 else h.astype(np.uint32))
    return ss, p
