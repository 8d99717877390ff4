"""Pairwise distances for the extra sketch types (WMH / HLL / OMH) on the GPU
(counterpart of ``rabbittclust_tpu/ops/extra_pairs.py``): kernel K8.

WMH and OMH similarities are positional token matches: sample s of genome
i matches sample s of genome j iff all token words are equal, so the whole
N x N similarity is one integer-equality count per pair.  HLL needs
per-pair register maxima; it stays on the host in float64, as in the JAX
package.

* ``tuple_matches`` — K8 (``csrc/tuple_match.cu``): (N, S, C) 32-bit token
  planes -> (N, N) int32 counts, as one C call that runs two passes: the
  class ids (``tuple_ids``: each sample's rows numbered by the smallest row
  with the same C words) and the pairs over the ids (one 32-bit compare a
  sample, over the lower triangle's 128 x 128 tiles, ``match_tiles``, each
  written with its transpose).  ``tuple_matches_plain`` is its plain torch
  version (a broadcast equality in row blocks); ``tuple_ids_plain`` and
  ``match_ids_plain`` are the two passes' plain versions.  On a CPU tensor
  the wrappers run the plain versions; on a CUDA tensor they launch the
  kernels or raise (the JAX wrapper's fallback to NumPy on any exception
  is not ported).  ``LAUNCHES`` counts K8's calls and its id pass's.

Counts are exact integers, so the kernel, the plain version and the JAX
program agree bit for bit, and so do the float64 distances built on them.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..sketch.extra import HllSketch, OmhSketch, WMinHashSketch, hll_distance
from .intersect import _launch

LAUNCHES = {"tuple_match": 0, "tuple_ids": 0}
# bytes of broadcast booleans one row block of the plain version may hold
PLAIN_BLOCK_BYTES = 1 << 26
# token words a sample K8 takes (csrc/tuple_match.cu instantiations)
MAX_WORDS = 8
# K8's pair tile (rows and columns) and the packed form's limits: two
# samples' ids a word as fp16 patterns below 0x7c00, a half's count exact
# to 2,048 (csrc/tuple_match.cu)
TILE = 128
PACK_MAX_N = 30720
PACK_MAX_WORDS = 2048


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Source: rabbittclust_tpu/ops/extra_pairs.py::_to_planes
def _to_planes(cols: List[np.ndarray]) -> np.ndarray:
    """Stack 64-bit token columns (each (N, S)) into (N, S, 2*len(cols))
    uint32 planes (lo, hi per column)."""
    planes = []
    for c in cols:
        c = c.astype(np.uint64)
        planes.append((c & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        planes.append((c >> np.uint64(32)).astype(np.uint32))
    return np.stack(planes, axis=-1)


def tuple_matches_plain(tok: torch.Tensor) -> torch.Tensor:
    """Plain K8: ``tok`` (N, S, C) int32 (the uint32 words' bit patterns) ->
    (N, N) int32, the count of samples s where all C words agree, as
    ``(tok[rows, None] == tok[None]).all(-1).sum(-1)`` over row blocks."""
    n, s, c = tok.shape
    out = torch.empty((n, n), dtype=torch.int32, device=tok.device)
    rows = max(1, PLAIN_BLOCK_BYTES // max(1, n * s * c))
    for r0 in range(0, n, rows):
        eq = (tok[r0:r0 + rows, None] == tok[None]).all(-1)
        out[r0:r0 + rows] = eq.sum(-1, dtype=torch.int32)
    return out


def tuple_ids_plain(tok: torch.Tensor) -> torch.Tensor:
    """Plain id pass: ``tok`` (N, S, C) int32 -> (S, N) int32, ids[q][i]
    the smallest row j whose C words at sample q equal row i's (one
    ``torch.unique`` over (sample, words) rows and an ``amin`` scatter)."""
    n, s, c = tok.shape
    q = torch.arange(s, dtype=torch.int32, device=tok.device)
    keyed = torch.cat([q.repeat_interleave(n)[:, None],
                       tok.transpose(0, 1).reshape(s * n, c)], 1)
    uniq, inv = torch.unique(keyed, dim=0, return_inverse=True)
    rows = torch.arange(n, device=tok.device).repeat(s)
    first = torch.full((uniq.shape[0],), n, dtype=torch.long,
                       device=tok.device)
    first.scatter_reduce_(0, inv, rows, "amin")
    return first[inv].view(s, n).to(torch.int32)


def match_ids_plain(ids: torch.Tensor) -> torch.Tensor:
    """Plain pair pass: (S, N) class ids -> (N, N) int32, the count of
    samples whose ids agree (in row blocks, as ``tuple_matches_plain``)."""
    s, n = ids.shape
    out = torch.empty((n, n), dtype=torch.int32, device=ids.device)
    rows = max(1, PLAIN_BLOCK_BYTES // max(1, n * s))
    for r0 in range(0, n, rows):
        eq = ids[:, r0:r0 + rows, None] == ids[:, None]
        out[r0:r0 + rows] = eq.sum(0, dtype=torch.int32)
    return out


def match_tiles(n: int) -> List[tuple]:
    """K8's pair kernel's walk (``tile_of``): block t's (by, bx) tile of
    TILE x TILE pairs, the lower triangle (bx <= by) row by row; each tile
    off the diagonal also writes its transpose."""
    nt = -(-n // TILE)
    out = []
    for t in range(nt * (nt + 1) // 2):
        y = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
        while y * (y + 1) // 2 > t:
            y -= 1
        while (y + 1) * (y + 2) // 2 <= t:
            y += 1
        out.append((y, t - y * (y + 1) // 2))
    return out


def _check_tokens(tok: torch.Tensor) -> None:
    if tok.dim() != 3 or tok.dtype != torch.int32:
        raise ValueError("tok must be an (N, S, C) int32 tensor")
    if tok.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tok on {tok.device}: expected cuda or cpu")
    n, s, c = tok.shape
    if not 1 <= c <= MAX_WORDS or s < 1 or not 0 < n <= 65535 * 64:
        raise ValueError(f"tok of shape {tuple(tok.shape)}: K8 takes 1 to "
                         f"{MAX_WORDS} words a sample, at least one sample "
                         "and 1 to 4,194,240 genomes")


def _id_scratch(tok: torch.Tensor):
    """The id pass's hash table (S x the least power of two >= 2N slots)
    and its ids, (S, N rounded up to TILE)."""
    n, s, _ = tok.shape
    n_pad = -(-n // TILE) * TILE
    table = torch.empty(s << (2 * n - 1).bit_length(), dtype=torch.int32,
                        device=tok.device)
    ids = torch.empty((s, n_pad), dtype=torch.int32, device=tok.device)
    return table, ids


def tuple_ids(tok: torch.Tensor) -> torch.Tensor:
    """K8's id pass alone: ``tuple_ids_plain``'s result from the kernels on
    a CUDA tensor; the plain version on a CPU tensor."""
    _check_tokens(tok)
    if tok.device.type == "cpu":
        return tuple_ids_plain(tok)
    tok = tok.contiguous()
    n, s, c = tok.shape
    table, ids = _id_scratch(tok)
    from ..kernels._build import load_kernels
    lib = load_kernels()
    with torch.cuda.device(tok.device):
        stream = torch.cuda.current_stream(tok.device).cuda_stream
        _launch(lib.rtc_tuple_ids, tok.data_ptr(), n, s, c,
                table.data_ptr(), ids.data_ptr(), stream)
    LAUNCHES["tuple_ids"] += 1
    return ids[:, :n]


def tuple_matches(tok: torch.Tensor) -> torch.Tensor:
    """K8: ``tuple_matches_plain``'s result, from one C call (the id pass,
    then the pairs, in the packed form where N and S allow it) on a CUDA
    tensor; the plain version on a CPU tensor."""
    _check_tokens(tok)
    if tok.device.type == "cpu":
        return tuple_matches_plain(tok)
    tok = tok.contiguous()
    n, s, c = tok.shape
    table, ids = _id_scratch(tok)
    pack = n <= PACK_MAX_N and (s + 1) // 2 <= PACK_MAX_WORDS
    words = torch.empty(((s + 1) // 2, ids.shape[1]), dtype=torch.int32,
                        device=tok.device) if pack else None
    out = torch.empty((n, n), dtype=torch.int32, device=tok.device)
    from ..kernels._build import load_kernels
    lib = load_kernels()
    with torch.cuda.device(tok.device):
        stream = torch.cuda.current_stream(tok.device).cuda_stream
        _launch(lib.rtc_tuple_match, tok.data_ptr(), n, s, c,
                table.data_ptr(), ids.data_ptr(),
                words.data_ptr() if pack else None, int(pack),
                out.data_ptr(), stream)
    LAUNCHES["tuple_match"] += 1
    LAUNCHES["tuple_ids"] += 1
    return out


# Source: rabbittclust_tpu/ops/extra_pairs.py::pairwise_tuple_matches
def pairwise_tuple_matches(tok: np.ndarray,
                           device: Optional[torch.device] = None
                           ) -> np.ndarray:
    """(N, S, C) uint32 token planes -> (N, N) int32 positional match counts
    (count of s where all C planes are equal), on ``device`` (``None``
    requires CUDA)."""
    n = tok.shape[0]
    if n == 0:
        return np.zeros((0, 0), dtype=np.int32)
    device = resolve_device(device)
    words = np.ascontiguousarray(tok, dtype=np.uint32).view(np.int32)
    return tuple_matches(torch.from_numpy(words).to(device)).cpu().numpy()


# Source: rabbittclust_tpu/ops/extra_pairs.py::_mash_from_jaccard
def _mash_from_jaccard(j: np.ndarray, kmer_size: int) -> np.ndarray:
    d = np.ones_like(j, dtype=np.float64)
    mid = (j > 0.0) & (j < 1.0)
    d[mid] = np.minimum(
        -1.0 / kmer_size * np.log(2.0 * j[mid] / (1.0 + j[mid])), 1.0)
    d[j >= 1.0] = 0.0
    return d


# Source: rabbittclust_tpu/ops/extra_pairs.py::wmh_pair_distances
def wmh_pair_distances(sketches: List[WMinHashSketch],
                       device: Optional[torch.device] = None) -> np.ndarray:
    """1 - (fraction of matching (idx, y) samples) for all pairs
    (== rabbittclust_tpu/sketch/extra.py::wminhash_distance)."""
    n = len(sketches)
    if n == 0:
        return np.zeros((0, 0), dtype=np.float64)
    idx = np.stack([s.idx for s in sketches])
    y = np.stack([s.y for s in sketches]).astype(np.int64)
    tok = _to_planes([idx, y.view(np.uint64)])
    counts = pairwise_tuple_matches(tok, device=device)
    return 1.0 - counts.astype(np.float64) / idx.shape[1]


# Source: rabbittclust_tpu/ops/extra_pairs.py::omh_pair_distances
def omh_pair_distances(sketches: List[OmhSketch], kmer_size: int,
                       device: Optional[torch.device] = None) -> np.ndarray:
    """Mash-transformed fraction of identical ordered l-tuples for all pairs
    (== rabbittclust_tpu/sketch/extra.py::omh_distance)."""
    n = len(sketches)
    if n == 0:
        return np.zeros((0, 0), dtype=np.float64)
    vecs = np.stack([s.vectors for s in sketches])  # (N, m, l)
    tok = _to_planes([vecs[:, :, c] for c in range(vecs.shape[2])])
    counts = pairwise_tuple_matches(tok, device=device)
    j = counts.astype(np.float64) / vecs.shape[1]
    return _mash_from_jaccard(j, kmer_size)


# Source: rabbittclust_tpu/ops/extra_pairs.py::hll_pair_distances
def hll_pair_distances(sketches: List[HllSketch],
                       kmer_size: int) -> np.ndarray:
    """Pairwise HLL Mash distances (inclusion-exclusion Jaccard), f64 host
    math == sketch.extra.hll_distance pairwise."""
    n = len(sketches)
    out = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            d = hll_distance(sketches[i], sketches[j], kmer_size)
            out[i, j] = out[j, i] = d
    return out
