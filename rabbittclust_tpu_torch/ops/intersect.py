"""Exact pairwise sketch-intersection counts (counterpart of
``rabbittclust_tpu/ops/intersect.py``).

Two kernels, written by hand for Hopper in ``csrc/pair_counts.cu``:

* K4 ``pair_counts_tiles`` — counts for a batch of (rb x rb) tiles of the
  resident planes; replaces the Pallas kernel ``pair_counts_row_pallas``.
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

LAUNCHES = {"pair_counts_tiles": 0, "pair_common": 0}


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
    of the JAX dispatcher ``pair_counts_row``): the plain version on CPU
    tensors, K4 on CUDA tensors (GI == N, one tile)."""
    if a0.device.type == "cpu":
        return pair_counts_plain(a0, b0, a1, b1)
    if a0.shape[0] != b0.shape[0]:
        raise ValueError("on CUDA pair_counts_row takes a square block")
    gi = a0.shape[0]
    two = a1 is not None
    p0 = torch.cat([a0, b0])
    p1 = torch.cat([a1, b1]) if two else None
    return pair_counts_tiles(p0, p1, [0], [gi], [1], gi)[0]


def _pair_counts_tiles_plain(p0, p1, r0s, c0s, valid, rb):
    out = torch.zeros((len(r0s), rb, rb), dtype=torch.int32,
                      device=p0.device)
    for t, (r0, c0, ok) in enumerate(zip(r0s, c0s, valid)):
        if ok:
            out[t] = pair_counts_plain(
                p0[r0:r0 + rb], p0[c0:c0 + rb],
                None if p1 is None else p1[r0:r0 + rb],
                None if p1 is None else p1[c0:c0 + rb])
    return out


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


def pair_counts_tiles(p0: torch.Tensor, p1: Optional[torch.Tensor],
                      r0s, c0s, valid, rb: int) -> torch.Tensor:
    """counts[t] = pair counts of rows [r0s[t], +rb) against columns
    [c0s[t], +rb) of the planes (n_pad, W, K): (batch, rb, rb) int32.
    ``r0s``, ``c0s`` and ``valid`` are host int sequences of one length;
    tiles with ``valid[t] == 0`` are not computed (zero on the CPU,
    unwritten on CUDA)."""
    r0s, c0s, valid = (np.asarray(x, dtype=np.int64).reshape(-1)
                       for x in (r0s, c0s, valid))
    if not len(r0s) == len(c0s) == len(valid):
        raise ValueError("r0s, c0s and valid differ in length")
    live = valid != 0
    if live.any() and (min(r0s[live].min(), c0s[live].min()) < 0 or
                       max(r0s[live].max(), c0s[live].max()) + rb
                       > p0.shape[0]):
        raise ValueError(f"a tile of {rb} rows leaves the {p0.shape[0]} "
                         "packed genomes")
    if p0.device.type == "cpu":
        return _pair_counts_tiles_plain(p0, p1, r0s, c0s, valid, rb)
    _check_planes(p0, p1)
    if rb % 32:
        raise ValueError(f"rb={rb}: must be a multiple of 32")
    from ..kernels._build import load_kernels
    lib = load_kernels()
    batch = len(r0s)
    _, w, k = p0.shape
    idx = _upload(np.stack([r0s, c0s, live]), p0.device)
    out = torch.empty((batch, rb, rb), dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        _launch(lib.rtc_pair_counts_tiles, p0.data_ptr(),
                (p0 if p1 is None else p1).data_ptr(), idx[0].data_ptr(),
                idx[1].data_ptr(), idx[2].data_ptr(), out.data_ptr(), batch,
                rb, w, k, int(p1 is not None), stream)
    LAUNCHES["pair_counts_tiles"] += 1
    return out


def pair_common_plain(p0: torch.Tensor, p1: Optional[torch.Tensor],
                      ii: torch.Tensor, jj: torch.Tensor,
                      chunk: int = 2048) -> torch.Tensor:
    """Exact common counts for explicit pairs (int tensors on the planes'
    device), (q,) int32; the chunked gather of ``_pair_common_fn``."""
    out = []
    for s in range(0, ii.shape[0], chunk):
        ic, jc = ii[s:s + chunk].long(), jj[s:s + chunk].long()
        eq = p0[ic][:, :, None, :] == p0[jc][:, None, :, :]
        if p1 is not None:
            eq &= p1[ic][:, :, None, :] == p1[jc][:, None, :, :]
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
    _check_planes(p0, p1)
    from ..kernels._build import load_kernels
    lib = load_kernels()
    q = len(ii)
    _, w, k = p0.shape
    pairs = _upload(np.stack([ii, jj]), p0.device)
    out = torch.empty(q, dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        _launch(lib.rtc_pair_common, p0.data_ptr(),
                (p0 if p1 is None else p1).data_ptr(), pairs[0].data_ptr(),
                pairs[1].data_ptr(), out.data_ptr(), q, w, k,
                int(p1 is not None), stream)
    LAUNCHES["pair_common"] += 1
    return out
