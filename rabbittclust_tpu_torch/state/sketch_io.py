"""Sketch / MST / index persistence — binary-compatible with the
reference.

Formats (little-endian raw structs, reference src/Sketch_IO.cpp,
src/MST_IO.cpp, src/SketchInfo.cpp:1254-1467):

  kssd.info.sketch / info.sketch (+ ".mst" twins):
      bool sketchByFile; size_t N;
      by-file rows:  int file_name_len, seq0_name_len, seq0_comment_len,
                     strand; uint64 totalSeqLength; the three strings
                     (+ bool use64, kssd only)
      by-seq rows:   int name_len, comment_len, strand, length; strings
                     (+ bool use64, kssd only)
  kssd.hash.sketch: KssdParameters{int id, half_k, half_subk, drlevel,
                     genomeNumber}; per genome size_t count + u32/u64 hashes
  hash.sketch:      int sketch_func_id (0=MinHash); int k,
                     bool isContainment, int containCompress|sketchSize;
                     per genome size_t count + u64 hashes
  kssd.sketch.index: size_t hash_number; u32/u64 hash_arr; u32 posting sizes
  kssd.sketch.dict:  concatenated u32 genome-id posting lists
  edge.mst:          size_t count; (int,int,double) triples
  mst.dense:         int genome_number, int denseSpan, denseSpan x N ints
  mst.ani:           101 x uint64
  minhash.sketch.index: "MHIDX001"; size_t keys; per key u64 hash, u32
                     posting size, u32 genome ids

One timestamped run folder per invocation: YYYY_MM_DD_HH-MM-SS
(reference common.hpp:36-44).
"""

from __future__ import annotations

import ctypes
import os
import struct
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from ..sketch.base import SketchSet
from ..sketch.kssd import KssdParams
from ..sketch.minhash import MinHashParams
from ..utils import native as native_mod


# Source: rabbittclust_tpu/state/sketch_io.py::default_folder_path
def default_folder_path(now: Optional[float] = None) -> str:
    t = time.localtime(now)
    return time.strftime("%Y_%m_%d_%H-%M-%S", t)


# Source: rabbittclust_tpu/state/sketch_io.py::ensure_folder
def ensure_folder(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


# Source: rabbittclust_tpu/state/sketch_io.py::save_genome_info
def save_genome_info(ss: SketchSet, folder: str, type_: str,
                     kssd: bool) -> None:
    assert type_ in ("sketch", "mst")
    name = ("kssd.info." if kssd else "info.") + type_
    with open(os.path.join(folder, name), "wb") as f:
        f.write(struct.pack("<?", ss.sketch_by_file))
        f.write(struct.pack("<Q", len(ss)))
        for i in range(len(ss)):
            if ss.sketch_by_file:
                fn = ss.file_names[i].encode()
                nm = ss.names[i].encode()
                cm = ss.comments[i].encode()
                f.write(struct.pack("<iiii", len(fn), len(nm), len(cm), 0))
                f.write(struct.pack("<Q", ss.total_lens[i]))
                f.write(fn)
                f.write(nm)
                f.write(cm)
            else:
                nm = ss.names[i].encode()
                cm = ss.comments[i].encode()
                f.write(struct.pack("<ii", len(nm), len(cm)))
                f.write(struct.pack("<ii", 0, ss.seq0_lens[i]))
                f.write(nm)
                f.write(cm)
            if kssd:
                f.write(struct.pack("<?", ss.use64))


# Source: rabbittclust_tpu/state/sketch_io.py::load_genome_info
def load_genome_info(folder: str, type_: str, kssd: bool
                     ) -> Tuple[bool, dict]:
    name = ("kssd.info." if kssd else "info.") + type_
    with open(os.path.join(folder, name), "rb") as f:
        data = f.read()
    off = 0
    (by_file,) = struct.unpack_from("<?", data, off); off += 1
    (n,) = struct.unpack_from("<Q", data, off); off += 8
    out = {"file_names": [], "names": [], "comments": [], "seq0_lens": [],
           "total_lens": [], "use64": False}
    for _ in range(n):
        if by_file:
            fl, nl, cl, _strand = struct.unpack_from("<iiii", data, off); off += 16
            (tl,) = struct.unpack_from("<Q", data, off); off += 8
            fn = data[off:off + fl].decode("utf-8", "replace"); off += fl
            nm = data[off:off + nl].decode("utf-8", "replace"); off += nl
            cm = data[off:off + cl].decode("utf-8", "replace"); off += cl
            out["file_names"].append(fn)
            out["names"].append(nm)
            out["comments"].append(cm)
            out["total_lens"].append(tl)
            out["seq0_lens"].append(0)
        else:
            nl, cl = struct.unpack_from("<ii", data, off); off += 8
            _strand, ln = struct.unpack_from("<ii", data, off); off += 8
            nm = data[off:off + nl].decode("utf-8", "replace"); off += nl
            cm = data[off:off + cl].decode("utf-8", "replace"); off += cl
            out["file_names"].append("")
            out["names"].append(nm)
            out["comments"].append(cm)
            out["seq0_lens"].append(ln)
            out["total_lens"].append(ln)
        if kssd:
            (u64,) = struct.unpack_from("<?", data, off); off += 1
            out["use64"] = bool(u64)
    return by_file, out


# Source: rabbittclust_tpu/state/sketch_io.py::save_kssd_sketches
def save_kssd_sketches(ss: SketchSet, p: KssdParams, folder: str) -> None:
    ensure_folder(folder)
    save_genome_info(ss, folder, "sketch", kssd=True)
    with open(os.path.join(folder, "kssd.hash.sketch"), "wb") as f:
        f.write(struct.pack("<iiiii", p.id, p.half_k, p.half_subk,
                            p.drlevel, len(ss)))
        for h in ss.hashes:
            f.write(struct.pack("<Q", len(h)))
            f.write(np.ascontiguousarray(h).tobytes())
    print(f"-----save the kssd sketches into: {folder}", file=sys.stderr)


# Source: rabbittclust_tpu/state/sketch_io.py::load_kssd_sketches
def load_kssd_sketches(folder: str) -> Tuple[SketchSet, KssdParams]:
    path = os.path.join(folder, "kssd.hash.sketch")
    with open(path, "rb") as f:
        data = f.read()
    _id, half_k, half_subk, drlevel, _n = struct.unpack_from("<iiiii", data, 0)
    p = KssdParams(half_k=half_k, half_subk=half_subk, drlevel=drlevel)
    by_file, info = load_genome_info(folder, "sketch", kssd=True)
    use64 = p.use64
    ss = SketchSet("kssd", p, by_file, use64)
    off = 20
    dt = np.uint64 if use64 else np.uint32
    width = 8 if use64 else 4
    n = len(info["names"])
    for i in range(n):
        (cnt,) = struct.unpack_from("<Q", data, off); off += 8
        h = np.frombuffer(data, dtype=dt, count=cnt, offset=off).copy()
        off += cnt * width
        ss.append_genome(
            file_name=info["file_names"][i], name=info["names"][i],
            comment=info["comments"][i], seq0_len=info["seq0_lens"][i],
            total_len=info["total_lens"][i], num_seqs=1, hashes=h)
    return ss, p


# Source: rabbittclust_tpu/state/sketch_io.py::save_minhash_sketches
def save_minhash_sketches(ss: SketchSet, folder: str, kmer_size: int,
                          is_containment: bool, contain_compress: int,
                          sketch_size: int) -> None:
    ensure_folder(folder)
    save_genome_info(ss, folder, "sketch", kssd=False)
    with open(os.path.join(folder, "hash.sketch"), "wb") as f:
        f.write(struct.pack("<i", 0))
        f.write(struct.pack("<i", kmer_size))
        f.write(struct.pack("<?", is_containment))
        f.write(struct.pack("<i", contain_compress if is_containment
                            else sketch_size))
        for h in ss.hashes:
            f.write(struct.pack("<Q", len(h)))
            f.write(np.ascontiguousarray(h, dtype=np.uint64).tobytes())
    print(f"-----save the sketches into: {folder}", file=sys.stderr)


# Source: rabbittclust_tpu/state/sketch_io.py::load_minhash_sketches
def load_minhash_sketches(folder: str) -> Tuple[SketchSet, MinHashParams]:
    path = os.path.join(folder, "hash.sketch")
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    (func_id,) = struct.unpack_from("<i", data, off); off += 4
    if func_id != 0:
        raise ValueError(f"hash.sketch has sketch_func_id={func_id}, not MinHash")
    (kmer_size,) = struct.unpack_from("<i", data, off); off += 4
    (is_containment,) = struct.unpack_from("<?", data, off); off += 1
    (param,) = struct.unpack_from("<i", data, off); off += 4
    by_file, info = load_genome_info(folder, "sketch", kssd=False)
    mp = MinHashParams(
        kmer_size=kmer_size, sketch_size=0 if is_containment else param,
        is_containment=bool(is_containment),
        contain_compress=param if is_containment else 0)
    ss = SketchSet("minhash", mp, by_file, True)
    n = len(info["names"])
    for i in range(n):
        (cnt,) = struct.unpack_from("<Q", data, off); off += 8
        h = np.frombuffer(data, dtype=np.uint64, count=cnt, offset=off).copy()
        off += cnt * 8
        # Reference load quirk (Sketch_IO.cpp:333-339): loaded containment
        # sketches are reconstructed as MinHash(kmer, contain_compress) —
        # getSketchSize() then returns the contain_compress CONSTANT, not
        # the original per-genome cap.  The presketched greedy path feeds
        # that degenerate size into its bounds/distances; replicate it.
        ss.append_genome(
            file_name=info["file_names"][i], name=info["names"][i],
            comment=info["comments"][i], seq0_len=info["seq0_lens"][i],
            total_len=info["total_lens"][i], num_seqs=1, hashes=h,
            param_size=param)
    return ss, mp


# Source: rabbittclust_tpu/state/sketch_io.py::save_minhash_index
def save_minhash_index(hashes: List[np.ndarray], folder: str) -> None:
    ensure_folder(folder)
    from ..cluster.mst import flatten_sketches
    hv, gid = flatten_sketches(hashes)
    hv_s, gid_s = _sorted_postings(hv, gid, hv.dtype == np.uint64)
    path = os.path.join(folder, "minhash.sketch.index")
    with open(path, "wb") as f:
        f.write(b"MHIDX001")
        if len(hv_s):
            starts = np.flatnonzero(np.r_[True, hv_s[1:] != hv_s[:-1]])
            sizes = np.diff(np.r_[starts, len(hv_s)])
            f.write(struct.pack("<Q", len(starts)))
            for st, sz in zip(starts.tolist(), sizes.tolist()):
                f.write(struct.pack("<Q", int(hv_s[st])))
                f.write(struct.pack("<I", sz))
                f.write(gid_s[st:st + sz].astype("<u4").tobytes())
        else:
            f.write(struct.pack("<Q", 0))
    print(f"-----MinHash inverted index saved: {path}", file=sys.stderr)


# Source: rabbittclust_tpu/state/sketch_io.py::_sorted_postings
def _sorted_postings(hv: np.ndarray, gid: np.ndarray, wide_hash: bool):
    """(hv, gid) sorted by (hash, gid).  32-bit hashes pack into one u64
    key and use a single non-stable sort (keys are unique, so the result
    is deterministic and identical to the stable hv-argsort)."""
    if not wide_hash and (len(gid) == 0 or int(gid[-1]) < (1 << 31)):
        key = (hv.astype(np.uint64) << np.uint64(32)) | \
            gid.astype(np.uint64)
        if len(key):
            native_mod.load_native().rtc_sort_u64(
                key.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                len(key), os.cpu_count() or 1)
        return ((key >> np.uint64(32)).astype(np.uint32),
                key.astype(np.uint32))  # low 32 bits
    order = np.argsort(hv, kind="stable")
    return hv[order], gid[order]


# Source: rabbittclust_tpu/state/sketch_io.py::save_kssd_index
def save_kssd_index(hashes: List[np.ndarray], use64: bool, folder: str) -> None:
    """Global inverted index from per-genome sorted hash arrays; entries
    written sorted by hash (deterministic; loader is order-agnostic)."""
    ensure_folder(folder)
    nthreads = os.cpu_count() or 1
    if not use64 and len(hashes) < (1 << 31):
        lib = native_mod.load_native()
        # all-native postings build: flatten -> pack (hash<<32|gid) ->
        # parallel sort -> unpack; keys are unique so the output equals
        # the stable-sort path's
        flat, offs = native_mod.flatten_csr(hashes, False)
        m = len(flat)
        key = np.empty(m, dtype=np.uint64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.rtc_pack_postings_u32(
            flat.ctypes.data_as(u32p), offs.ctypes.data_as(i64p),
            len(hashes), key.ctypes.data_as(u64p), nthreads)
        lib.rtc_sort_u64(key.ctypes.data_as(u64p), m, nthreads)
        hv_s = np.empty(m, dtype=np.uint32)
        gid_s = np.empty(m, dtype=np.uint32)
        lib.rtc_unpack_postings_u32(
            key.ctypes.data_as(u64p), m, hv_s.ctypes.data_as(u32p),
            gid_s.ctypes.data_as(u32p), nthreads)
    else:
        from ..cluster.mst import flatten_sketches
        hv, gid = flatten_sketches(hashes)
        hv_s, gid_s = _sorted_postings(hv, gid, use64)
    if len(hv_s):
        starts = np.flatnonzero(np.r_[True, hv_s[1:] != hv_s[:-1]])
        uniq = hv_s[starts]
        sizes = np.diff(np.r_[starts, len(hv_s)]).astype(np.uint32)
    else:
        uniq = hv_s
        sizes = np.empty(0, dtype=np.uint32)
    with open(os.path.join(folder, "kssd.sketch.dict"), "wb") as f:
        f.write(gid_s.astype(np.uint32).tobytes())
    with open(os.path.join(folder, "kssd.sketch.index"), "wb") as f:
        f.write(struct.pack("<Q", len(uniq)))
        f.write(np.ascontiguousarray(
            uniq, dtype=np.uint64 if use64 else np.uint32).tobytes())
        f.write(sizes.tobytes())


# Source: rabbittclust_tpu/state/sketch_io.py::save_mst
def save_mst(mst, folder: str) -> None:
    ensure_folder(folder)
    i, j, d = mst
    with open(os.path.join(folder, "edge.mst"), "wb") as f:
        f.write(struct.pack("<Q", len(i)))
        rec = np.zeros(len(i), dtype=np.dtype(
            [("i", "<i4"), ("j", "<i4"), ("d", "<f8")]))
        rec["i"] = i
        rec["j"] = j
        rec["d"] = d
        f.write(rec.tobytes())
    print(f"-----save the mst into: {folder}", file=sys.stderr)


# Source: rabbittclust_tpu/state/sketch_io.py::load_mst
def load_mst(folder: str):
    with open(os.path.join(folder, "edge.mst"), "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        rec = np.frombuffer(f.read(n * 16), dtype=np.dtype(
            [("i", "<i4"), ("j", "<i4"), ("d", "<f8")]))
    return (rec["i"].astype(np.int64), rec["j"].astype(np.int64),
            rec["d"].astype(np.float64))


# Source: rabbittclust_tpu/state/sketch_io.py::save_dense
def save_dense(folder: str, dense: np.ndarray) -> None:
    ensure_folder(folder)
    span, n = dense.shape
    with open(os.path.join(folder, "mst.dense"), "wb") as f:
        f.write(struct.pack("<ii", n, span))
        f.write(dense.astype("<i4").tobytes())


# Source: rabbittclust_tpu/state/sketch_io.py::load_dense
def load_dense(folder: str) -> np.ndarray:
    with open(os.path.join(folder, "mst.dense"), "rb") as f:
        n, span = struct.unpack("<ii", f.read(8))
        return np.frombuffer(f.read(span * n * 4),
                             dtype="<i4").reshape(span, n).copy()


# Source: rabbittclust_tpu/state/sketch_io.py::save_ani
def save_ani(folder: str, ani: np.ndarray) -> None:
    ensure_folder(folder)
    with open(os.path.join(folder, "mst.ani"), "wb") as f:
        f.write(ani.astype("<u8").tobytes())


# Source: rabbittclust_tpu/state/sketch_io.py::load_ani
def load_ani(folder: str) -> np.ndarray:
    with open(os.path.join(folder, "mst.ani"), "rb") as f:
        return np.frombuffer(f.read(101 * 8), dtype="<u8").copy()
