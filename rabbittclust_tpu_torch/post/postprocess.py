"""Cluster postprocessing: dedup medoids + k-representative selection.

Re-derivation of reference src/cluster_postprocess.cpp:
  * build_dedup_candidates_per_cluster — collapse near-duplicate nodes
    connected by forest edges with dist <= dedup_dist into their tree-medoid
    (minimum total tree distance; ties: longer sequence, then smaller id);
  * select_k_reps_per_cluster_tree — farthest-first (k-center) traversal on
    the tree metric, seeded with the component diameter endpoints.

Outputs <output>.dedup and <output>.reps (sub_command.cpp:2089-2103).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from ..cluster.union_find import UnionFind


# Source: rabbittclust_tpu/post/postprocess.py::_build_adj
def _build_adj(n: int, forest, max_dist: float = None):
    adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    fi, fj, fd = forest
    for u, v, w in zip(fi.tolist(), fj.tolist(), fd.tolist()):
        if max_dist is not None and w > max_dist:
            continue
        if 0 <= u < n and 0 <= v < n:
            adj[u].append((v, w))
            adj[v].append((u, w))
    return adj


# Source: rabbittclust_tpu/post/postprocess.py::_distances_from
def _distances_from(start: int, adj) -> List[float]:
    m = len(adj)
    dist = [-1.0] * m
    parent = [-1] * m
    stack = [start]
    dist[start] = 0.0
    parent[start] = start
    while stack:
        u = stack.pop()
        for v, w in adj[u]:
            if v == parent[u]:
                continue
            parent[v] = u
            dist[v] = dist[u] + w
            stack.append(v)
    return dist


# Source: rabbittclust_tpu/post/postprocess.py::build_dedup_candidates_per_cluster
def build_dedup_candidates_per_cluster(clusters, forest, seq_lens,
                                       dedup_dist: float):
    """Returns (candidates_per_cluster, node_to_rep)."""
    n = len(seq_lens)
    if dedup_dist <= 0:
        return [list(c) for c in clusters], list(range(n))
    adj = _build_adj(n, forest, max_dist=dedup_dist)
    uf = UnionFind(n)
    fi, fj, fd = forest
    for u, v, w in zip(fi.tolist(), fj.tolist(), fd.tolist()):
        if w <= dedup_dist:
            uf.merge(u, v)
    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(uf.find(i), []).append(i)
    best_rep = {}
    for root, members in groups.items():
        if len(members) == 1:
            best_rep[root] = members[0]
            continue
        chosen = members[0]
        min_total = float("inf")
        chosen_len = 0
        for cand in members:
            dist = _distances_from(cand, adj)
            total = sum(dist[m] for m in members if m != cand and dist[m] >= 0)
            cand_len = seq_lens[cand]
            if (total < min_total or
                    (total == min_total and
                     (cand_len > chosen_len or
                      (cand_len == chosen_len and cand < chosen)))):
                min_total = total
                chosen = cand
                chosen_len = cand_len
        best_rep[root] = chosen
    node_to_rep = [best_rep.get(uf.find(i), i) for i in range(n)]
    candidates = []
    for cl in clusters:
        seen = set()
        cand = []
        for node in cl:
            rep = node_to_rep[node]
            if rep not in seen:
                seen.add(rep)
                cand.append(rep)
        candidates.append(sorted(cand))
    return candidates, node_to_rep


# Source: rabbittclust_tpu/post/postprocess.py::select_k_reps_per_cluster_tree
def select_k_reps_per_cluster_tree(clusters_original, candidates_per_cluster,
                                   forest, n: int, node_to_rep, k: int):
    reps: List[List[int]] = []
    if k <= 0:
        return [[] for _ in clusters_original]
    adj = _build_adj(n, forest)
    for ci, comp_nodes in enumerate(clusters_original):
        candidates = candidates_per_cluster[ci]
        if not candidates:
            reps.append([])
            continue
        if len(candidates) <= k:
            reps.append(list(candidates))
            continue
        m = len(comp_nodes)
        idx = {g: i for i, g in enumerate(comp_nodes)}
        ladj: List[List[Tuple[int, float]]] = [[] for _ in range(m)]
        for i, u in enumerate(comp_nodes):
            for v, w in adj[u]:
                li = idx.get(v)
                if li is not None:
                    ladj[i].append((li, w))

        def farthest(start):
            d = _distances_from(start, ladj)
            far, best = start, -1.0
            for i, dd in enumerate(d):
                if dd > best:
                    best, far = dd, i
            return far, d

        u, _ = farthest(0)
        v, _ = farthest(u)
        cand_set = set(candidates)

        def map_to_candidate(node_id: int) -> int:
            rep = node_to_rep[node_id] if 0 <= node_id < len(node_to_rep) else node_id
            if rep in cand_set:
                return rep
            if node_id in cand_set:
                return node_id
            return candidates[0]

        chosen: List[int] = []
        chosen_set = set()
        r1 = map_to_candidate(comp_nodes[u])
        if r1 not in chosen_set:
            chosen_set.add(r1)
            chosen.append(r1)
        if len(chosen) < k:
            r2 = map_to_candidate(comp_nodes[v])
            if r2 not in chosen_set:
                chosen_set.add(r2)
                chosen.append(r2)
        min_dist = [float("inf")] * m

        def add_rep(rep_gid: int):
            li = idx.get(rep_gid)
            if li is None:
                return
            d = _distances_from(li, ladj)
            for i in range(m):
                if 0.0 <= d[i] < min_dist[i]:
                    min_dist[i] = d[i]

        for r in chosen:
            add_rep(r)
        cand_local = [idx[c] for c in candidates if c in idx]
        while len(chosen) < k:
            best_local, best_score = -1, -1.0
            for li in cand_local:
                mapped = map_to_candidate(comp_nodes[li])
                if mapped in chosen_set:
                    continue
                if min_dist[li] > best_score:
                    best_score = min_dist[li]
                    best_local = li
            if best_local < 0:
                break
            nxt = map_to_candidate(comp_nodes[best_local])
            if nxt in chosen_set:
                break
            chosen_set.add(nxt)
            chosen.append(nxt)
            add_rep(nxt)
        reps.append(sorted(chosen))
    return reps


# Source: rabbittclust_tpu/post/postprocess.py::dedup_and_reps
def dedup_and_reps(ss, forest, clusters, dedup_dist: float,
                   reps_per_cluster: int, output_file: str) -> None:
    from ..state.cluster_io import write_cluster_file
    n = len(ss)
    seq_lens = [ss.display_length(i) for i in range(n)]
    candidates, node_to_rep = build_dedup_candidates_per_cluster(
        clusters, forest, seq_lens, dedup_dist)
    if dedup_dist >= 0.0:
        write_cluster_file(output_file + ".dedup", candidates, ss)
        print(f"-----write the dedup candidates into: {output_file}.dedup",
              file=sys.stderr)
    if reps_per_cluster > 0:
        reps = select_k_reps_per_cluster_tree(
            clusters, candidates, forest, n, node_to_rep, reps_per_cluster)
        write_cluster_file(output_file + ".reps", reps, ss)
        print(f"-----write the representatives into: {output_file}.reps",
              file=sys.stderr)
