"""MST cluster state (tree-medoid RepDB) for clust-mst --save-rep / --append.

Re-derivation of reference src/mst_state.{h,cpp}:
  * each MST-cut cluster is collapsed to one tree-medoid representative
    (build_dedup_candidates_per_cluster with dedup_dist = +inf);
  * append: probe rep inverted index -> greedy-style size-ratio
    (radio = e^{dk}, mst_state.cpp:908) + min-common filters -> exact
    jaccard-from-count distances -> decide_assignment: 1 match = join,
    multi-match = merge clusters via UnionFind, 0 = new cluster;
  * retired reps compacted + index rebuilt after each append batch;
  * serialization: "KSMSTST01" / "MHMSTST01" layouts (mst_state.cpp:91-345).

Copied from ``rabbittclust_tpu/state/mst_state.py``; the inverted index is
written and read whole (``postings.py``), the same dict and bytes.
"""

from __future__ import annotations

import math
import struct
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..cluster.union_find import UnionFind
from ..sketch.base import SketchSet
from ..sketch.kssd import KssdParams
from .postings import pack_postings, read_postings

_KSSD_MAGIC = b"KSMSTST01"  # reference writes exactly these 9 bytes
_MH_MAGIC = b"MHMSTST01"


# Source: rabbittclust_tpu/state/mst_state.py::_mash_from_counts
def _mash_from_counts(common: int, size_a: int, size_b: int,
                      kmer_size: int) -> float:
    denom = size_a + size_b - common
    if denom <= 0:
        return 1.0
    j = common / denom
    if j >= 1.0:
        return 0.0
    if j <= 0.0:
        return 1.0
    d = -math.log(2.0 * j / (1.0 + j)) / kmer_size
    return min(d, 1.0)


# Source: rabbittclust_tpu/state/mst_state.py::MstState (the index
# written and read by postings.py)
@dataclass
class MstState:
    """Unified MST state; `kind` selects the on-disk layout/magic."""

    kind: str                   # "kssd" | "minhash"
    threshold: float
    kmer_size: int
    # kssd params
    half_k: int = 0
    half_subk: int = 0
    drlevel: int = 0
    use64: bool = False
    # minhash params
    sketch_size: int = 0
    contain_compress: int = 0
    is_containment: bool = False

    n: int = 0
    sketch_by_file: bool = True
    representative_ids: List[int] = field(default_factory=list)
    rep_hashes: List[np.ndarray] = field(default_factory=list)
    rep_file_names: List[str] = field(default_factory=list)
    rep_total_lens: List[int] = field(default_factory=list)
    clusters: List[List[int]] = field(default_factory=list)
    member_names: List[str] = field(default_factory=list)
    member_lens: List[int] = field(default_factory=list)
    inverted_index: Dict[int, List[int]] = field(default_factory=dict)

    # ---- construction -----------------------------------------------------

    @classmethod
    def from_clustering(cls, ss: SketchSet, kind: str, forest, clusters,
                        threshold: float, **params) -> "MstState":
        from ..post.postprocess import build_dedup_candidates_per_cluster
        st = cls(kind=kind, threshold=threshold,
                 kmer_size=params.get("kmer_size", 0),
                 half_k=params.get("half_k", 0),
                 half_subk=params.get("half_subk", 0),
                 drlevel=params.get("drlevel", 0), use64=ss.use64,
                 sketch_size=params.get("sketch_size", 0),
                 contain_compress=params.get("contain_compress", 0),
                 is_containment=params.get("is_containment", False),
                 sketch_by_file=ss.sketch_by_file)
        st.n = len(ss)
        st.member_names = [ss.file_names[i] if ss.sketch_by_file
                           else ss.names[i] for i in range(len(ss))]
        st.member_lens = [ss.display_length(i) for i in range(len(ss))]
        seq_lens = st.member_lens
        cands, _ = build_dedup_candidates_per_cluster(
            clusters, forest, seq_lens, float("inf"))
        for i, cl in enumerate(clusters):
            if not cl:
                continue
            rep_id = cands[i][0] if cands[i] else cl[0]
            if not (0 <= rep_id < st.n):
                rep_id = cl[0]
            st.representative_ids.append(rep_id)
            st.rep_hashes.append(ss.hashes[rep_id])
            st.rep_file_names.append(st.member_names[rep_id])
            st.rep_total_lens.append(st.member_lens[rep_id])
            st.clusters.append(list(cl))
        st.build_inverted_index()
        return st

    def build_inverted_index(self) -> None:
        self.inverted_index = {}
        for rep_idx, h in enumerate(self.rep_hashes):
            for hv in h.tolist():
                lst = self.inverted_index.get(hv)
                if lst is None:
                    self.inverted_index[hv] = [rep_idx]
                else:
                    lst.append(rep_idx)

    # ---- append (KssdMstAppendCluster / MinHashMstAppendCluster) ----------

    def append_cluster(self, new_ss: SketchSet) -> List[List[int]]:
        uf = UnionFind(max(len(self.rep_hashes), 1))
        exp_dk = math.exp(-self.threshold * self.kmer_size)
        j_min = exp_dk / (2.0 - exp_dk)
        radio = 1.0 / exp_dk  # e^{dk}, mst_state.cpp:908
        assigned = merged_total = created = 0

        def uf_find(i):
            return uf.find(i) if i < len(uf.parent) else i

        for k in range(len(new_ss)):
            h = new_ss.hashes[k]
            size_qry = len(h)
            hits: Dict[int, int] = {}
            for hv in h.tolist():
                lst = self.inverted_index.get(hv)
                if lst is None:
                    continue
                for r in lst:
                    hits[r] = hits.get(r, 0) + 1
            seen_roots = set()
            cand_roots = []
            for r in hits:
                root = uf_find(r)
                if root not in seen_roots:
                    seen_roots.add(root)
                    cand_roots.append(root)
            matches = []
            for r in cand_roots:
                common = hits.get(r)
                if common is None:
                    continue
                size_ref = len(self.rep_hashes[r])
                if size_ref == 0:
                    continue
                ratio = size_qry / size_ref
                if ratio > radio or ratio < 1.0 / radio:
                    continue
                if common < int(j_min * (size_qry + size_ref) / (1.0 + j_min)):
                    continue
                d = _mash_from_counts(common, size_qry, size_ref,
                                      self.kmer_size)
                if d <= self.threshold:
                    matches.append((r, d))
            new_node_id = self.n
            self.n += 1
            name = (new_ss.file_names[k] if self.sketch_by_file
                    else new_ss.names[k])
            self.member_names.append(name)
            self.member_lens.append(new_ss.display_length(k))
            if not matches:
                new_rep_idx = len(self.rep_hashes)
                self.representative_ids.append(new_node_id)
                self.rep_hashes.append(h)
                self.rep_file_names.append(name)
                self.rep_total_lens.append(self.member_lens[-1])
                self.clusters.append([new_node_id])
                for hv in h.tolist():
                    self.inverted_index.setdefault(hv, []).append(new_rep_idx)
                # extend union-find
                uf.parent = np.append(uf.parent, new_rep_idx)
                uf.rank = np.append(uf.rank, 0)
                created += 1
            else:
                best = min(range(len(matches)), key=lambda i: matches[i][1])
                survivor = matches[best][0]
                for i, (other, _d) in enumerate(matches):
                    if i == best:
                        continue
                    other_root = uf_find(other)
                    surv_root = uf_find(survivor)
                    if other_root == surv_root:
                        continue
                    uf.merge(surv_root, other_root)
                    new_root = uf_find(surv_root)
                    loser = other_root if new_root == surv_root else surv_root
                    self.clusters[new_root].extend(self.clusters[loser])
                    self.clusters[loser] = []
                    merged_total += 1
                final_root = uf_find(survivor)
                self.clusters[final_root].append(new_node_id)
                assigned += 1
        print(f"  assigned to existing : {assigned}\n"
              f"  new clusters         : {created}\n"
              f"  cluster merges       : {merged_total}", file=sys.stderr)
        live = [cl for i, cl in enumerate(self.clusters)
                if cl and uf_find(i) == i]
        self._compact(uf)
        return live

    def _compact(self, uf: UnionFind) -> None:
        keep = [i for i in range(len(self.rep_hashes))
                if self.clusters[i] and
                (i >= len(uf.parent) or uf.find(i) == i)]
        if len(keep) == len(self.rep_hashes):
            return
        self.representative_ids = [self.representative_ids[i] for i in keep]
        self.rep_hashes = [self.rep_hashes[i] for i in keep]
        self.rep_file_names = [self.rep_file_names[i] for i in keep]
        self.rep_total_lens = [self.rep_total_lens[i] for i in keep]
        self.clusters = [self.clusters[i] for i in keep]
        self.build_inverted_index()

    # ---- query / assign / stats ------------------------------------------

    def query_topk(self, query_hashes: np.ndarray, topk: int):
        exp_dk = math.exp(-self.threshold * self.kmer_size)
        j_min = exp_dk / (2.0 - exp_dk)
        radio = 1.0 / exp_dk
        size_qry = len(query_hashes)
        hits: Dict[int, int] = {}
        for hv in query_hashes.tolist():
            lst = self.inverted_index.get(hv)
            if lst is None:
                continue
            for r in lst:
                hits[r] = hits.get(r, 0) + 1
        scored = []
        for r, common in hits.items():
            size_ref = len(self.rep_hashes[r])
            if size_ref == 0 or not self.clusters[r]:
                continue
            ratio = size_qry / size_ref
            if ratio > radio or ratio < 1.0 / radio:
                continue
            if common < int(j_min * (size_qry + size_ref) / (1.0 + j_min)):
                continue
            d = _mash_from_counts(common, size_qry, size_ref, self.kmer_size)
            scored.append((d, r))
        scored.sort(key=lambda t: (t[0], t[1]))
        out = []
        for d, r in scored[:topk] if topk > 0 else scored:
            out.append({"rep_idx": r,
                        "genome_id": self.representative_ids[r],
                        "genome_name": self.rep_file_names[r],
                        "distance": d, "cluster_id": r,
                        "cluster_size": len(self.clusters[r])})
        return out

    def assign(self, query_hashes: np.ndarray):
        res = self.query_topk(query_hashes, 1)
        if res and res[0]["distance"] <= self.threshold:
            return res[0]
        return {"rep_idx": -1, "genome_id": -1, "genome_name": "unassigned",
                "distance": -1.0, "cluster_id": -1, "cluster_size": 0}

    def _print_cluster_size_histogram(self, w) -> None:
        """Reference print_cluster_size_histogram (mst_state.cpp:1338-1378):
        buckets 1, 2, 3-5, 6-10, 11-100, 101-1000, >1000 over live (non-
        empty) clusters."""
        buckets = [0] * 7
        live = 0
        total = 0
        max_size = 0
        min_size = 1 << 31
        for c in self.clusters:
            sz = len(c)
            if sz == 0:
                continue
            live += 1
            total += sz
            max_size = max(max_size, sz)
            min_size = min(min_size, sz)
            if sz == 1:
                buckets[0] += 1
            elif sz == 2:
                buckets[1] += 1
            elif sz <= 5:
                buckets[2] += 1
            elif sz <= 10:
                buckets[3] += 1
            elif sz <= 100:
                buckets[4] += 1
            elif sz <= 1000:
                buckets[5] += 1
            else:
                buckets[6] += 1
        if live == 0:
            min_size = 0
        w(f"  Live clusters:    {live}\n")
        w(f"  Total members:    {total}\n")
        avg = total / live if live else 0.0
        w(f"  Cluster size:     min={min_size} max={max_size} "
          f"avg={avg:.2f}\n")
        w("  Size histogram:\n")
        labels = ("size=1        ", "size=2        ", "size=3-5      ",
                  "size=6-10     ", "size=11-100   ", "size=101-1000 ",
                  "size>1000     ")
        for lab, b in zip(labels, buckets):
            w(f"    {lab} : {b}\n")

    def print_stats(self, out=sys.stdout) -> None:
        """Byte-identical to the reference's KssdMstPrintStats /
        MinHashMstPrintStats (mst_state.cpp:1381-1412)."""
        total = sum(len(c) for c in self.clusters)
        w = out.write
        if self.kind == "kssd":
            w("========== KSSD MST RepDB stats ==========\n")
            w(f"  Kmer size:        {self.kmer_size}\n")
            w(f"  half_k:           {self.half_k}\n")
            w(f"  half_subk:        {self.half_subk}\n")
            w(f"  drlevel:          {self.drlevel}\n")
            w(f"  use64:            {'yes' if self.use64 else 'no'}\n")
            w(f"  Threshold:        {self.threshold:.6f}\n")
            w(f"  Total reps slots: {len(self.rep_hashes)}\n")
            w(f"  sketch_by_file:   "
              f"{'yes' if self.sketch_by_file else 'no'}\n")
            w(f"  Total members N:  {total}\n")
            bits = "64-bit" if self.use64 else "32-bit"
            w(f"  Inverted index:   {len(self.inverted_index)} unique "
              f"hashes ({bits})\n")
            self._print_cluster_size_histogram(w)
            w("==========================================\n")
        else:
            w("========== MinHash MST RepDB stats ==========\n")
            w(f"  Kmer size:        {self.kmer_size}\n")
            w(f"  Sketch size:      {self.sketch_size}\n")
            w(f"  Containment:      "
              f"{'yes' if self.is_containment else 'no'}\n")
            if self.is_containment:
                w(f"  Contain compress: {self.contain_compress}\n")
            w(f"  Threshold:        {self.threshold:.6f}\n")
            w(f"  Total reps slots: {len(self.rep_hashes)}\n")
            w(f"  sketch_by_file:   "
              f"{'yes' if self.sketch_by_file else 'no'}\n")
            w(f"  Total members N:  {total}\n")
            w(f"  Inverted index:   {len(self.inverted_index)} unique "
              f"hashes\n")
            self._print_cluster_size_histogram(w)
            w("==============================================\n")

    # ---- output ----------------------------------------------------------

    def write_cluster_result(self, clusters, output_file: str,
                             threshold: Optional[float] = None) -> None:
        """printMstStateClusterResult format (mst_state.cpp:1108-1146)."""
        with open(output_file, "w") as fp:
            if threshold is not None and threshold >= 0.0:
                fp.write(f"# Clustering threshold: {threshold:.6f}\n")
                fp.write(f"# Total clusters: {len(clusters)}\n")
                fp.write("#\n")
            for i, cl in enumerate(clusters):
                fp.write(f"the cluster {i} is: \n")
                for j, gid in enumerate(cl):
                    name = (self.member_names[gid]
                            if 0 <= gid < len(self.member_names) else "N/A")
                    ln = (self.member_lens[gid]
                          if 0 <= gid < len(self.member_lens) else 0)
                    if self.sketch_by_file:
                        fp.write("\t%5d\t%6d\t%12dnt\t%20s\n" % (j, gid, ln, name))
                    else:
                        fp.write("\t%6d\t%6d\t%12dnt\t%20s\n" % (j, gid, ln, name))
                fp.write("\n")

    # ---- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            if self.kind == "kssd":
                f.write(_KSSD_MAGIC)  # exactly 9 bytes (mst_state.cpp:299)
                f.write(struct.pack("<d", self.threshold))
                f.write(struct.pack("<iiii", self.kmer_size, self.half_k,
                                    self.half_subk, self.drlevel))
                f.write(struct.pack("<??", self.use64, self.sketch_by_file))
                f.write(struct.pack("<i", self.n))
            else:
                f.write(_MH_MAGIC)  # exactly 9 bytes
                f.write(struct.pack("<d", self.threshold))
                f.write(struct.pack("<iii", self.kmer_size, self.sketch_size,
                                    self.contain_compress))
                f.write(struct.pack("<??", self.is_containment,
                                    self.sketch_by_file))
                f.write(struct.pack("<i", self.n))
            f.write(struct.pack("<Q", len(self.rep_hashes)))
            for i, h in enumerate(self.rep_hashes):
                f.write(struct.pack("<i", self.representative_ids[i]))
                f.write(struct.pack("<Q", self.rep_total_lens[i]))
                name = self.rep_file_names[i].encode()
                f.write(struct.pack("<I", len(name)))
                f.write(name)
                f.write(struct.pack("<Q", len(h)))
                f.write(np.ascontiguousarray(h).tobytes())
            f.write(struct.pack("<Q", len(self.clusters)))
            for cl in self.clusters:
                f.write(struct.pack("<Q", len(cl)))
                f.write(np.asarray(cl, dtype="<i4").tobytes())
            f.write(struct.pack("<Q", len(self.member_names)))
            for nm in self.member_names:
                b = nm.encode()
                f.write(struct.pack("<I", len(b)))
                f.write(b)
            f.write(struct.pack("<Q", len(self.member_lens)))
            f.write(np.asarray(self.member_lens, dtype="<u8").tobytes())
            key64 = self.kind == "minhash" or self.use64
            f.write(pack_postings(self.inverted_index, 8 if key64 else 4))
        print(f"Saved MST state to {path} (reps={len(self.rep_hashes)})",
              file=sys.stderr)

    @classmethod
    def load(cls, path: str) -> "MstState":
        with open(path, "rb") as f:
            data = f.read()
        magic = data[:9]
        off = 9
        if magic == _KSSD_MAGIC:
            (threshold,) = struct.unpack_from("<d", data, off); off += 8
            k, hk, hs, dl = struct.unpack_from("<iiii", data, off); off += 16
            u64, byf = struct.unpack_from("<??", data, off); off += 2
            (n,) = struct.unpack_from("<i", data, off); off += 4
            st = cls(kind="kssd", threshold=threshold, kmer_size=k,
                     half_k=hk, half_subk=hs, drlevel=dl, use64=bool(u64),
                     sketch_by_file=bool(byf))
            st.n = n
            hdt = np.uint64 if u64 else np.uint32
            hwidth = 8 if u64 else 4
        elif magic == _MH_MAGIC:
            (threshold,) = struct.unpack_from("<d", data, off); off += 8
            k, ssz, cc = struct.unpack_from("<iii", data, off); off += 12
            isc, byf = struct.unpack_from("<??", data, off); off += 2
            (n,) = struct.unpack_from("<i", data, off); off += 4
            st = cls(kind="minhash", threshold=threshold, kmer_size=k,
                     sketch_size=ssz, contain_compress=cc,
                     is_containment=bool(isc), sketch_by_file=bool(byf),
                     use64=True)
            st.n = n
            hdt = np.uint64
            hwidth = 8
        else:
            raise ValueError(f"bad MST state magic in {path}")
        (nrep,) = struct.unpack_from("<Q", data, off); off += 8
        for _ in range(nrep):
            (rid,) = struct.unpack_from("<i", data, off); off += 4
            (tl,) = struct.unpack_from("<Q", data, off); off += 8
            (nl,) = struct.unpack_from("<I", data, off); off += 4
            name = data[off:off + nl].decode("utf-8", "replace"); off += nl
            (hn,) = struct.unpack_from("<Q", data, off); off += 8
            h = np.frombuffer(data, dtype=hdt, count=hn, offset=off).copy()
            off += hn * hwidth
            st.representative_ids.append(rid)
            st.rep_total_lens.append(tl)
            st.rep_file_names.append(name)
            st.rep_hashes.append(h)
        (ncl,) = struct.unpack_from("<Q", data, off); off += 8
        for _ in range(ncl):
            (m,) = struct.unpack_from("<Q", data, off); off += 8
            st.clusters.append(np.frombuffer(
                data, dtype="<i4", count=m, offset=off).tolist())
            off += 4 * m
        (nm,) = struct.unpack_from("<Q", data, off); off += 8
        for _ in range(nm):
            (nl,) = struct.unpack_from("<I", data, off); off += 4
            st.member_names.append(
                data[off:off + nl].decode("utf-8", "replace")); off += nl
        (ml,) = struct.unpack_from("<Q", data, off); off += 8
        st.member_lens = np.frombuffer(data, dtype="<u8", count=ml,
                                       offset=off).tolist()
        off += 8 * ml
        key64 = st.kind == "minhash" or st.use64
        st.inverted_index, off = read_postings(data, off,
                                               8 if key64 else 4)
        print(f"Loaded MST state from {path} (reps={nrep}, clusters={ncl}, "
              f"members={nm})", file=sys.stderr)
        return st


# Source: rabbittclust_tpu/state/mst_state.py::KssdMstState
class KssdMstState:
    """Factory helpers mirroring the reference entry points."""

    @staticmethod
    def from_clustering(ss: SketchSet, p: KssdParams, mst, clusters,
                        threshold: float) -> MstState:
        from ..cluster.mst import cut_forest
        forest = cut_forest(mst, threshold)
        return MstState.from_clustering(
            ss, "kssd", forest, clusters, threshold,
            kmer_size=p.kmer_size, half_k=p.half_k, half_subk=p.half_subk,
            drlevel=p.drlevel)
