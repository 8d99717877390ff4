"""Tree / linkage outputs from the MST (reference src/MST.cpp:1088-1287,
src/MST_IO.cpp:252-375).

The dendrogram is built by Kruskal-order agglomeration: edges ascending by
distance; merging two components creates an internal node at height =
edge distance, with branch length = height - child height (clamped >= 0).
Newick branch lengths use C++ std::to_string formatting (6 decimals).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..cluster.union_find import UnionFind


# Source: rabbittclust_tpu/post/trees.py::_agglomerate
def _agglomerate(n: int, mst) -> Tuple[List[List[Tuple[int, float]]], int]:
    i_arr, j_arr, d_arr = mst
    order = np.lexsort((j_arr, i_arr, d_arr))
    children: List[List[Tuple[int, float]]] = [[] for _ in range(2 * n - 1)]
    height = [0.0] * (2 * n - 1)
    rep_node = list(range(n)) + [-1] * (n - 1)
    uf = UnionFind(n)
    next_node = n
    for k in order:
        u, v, w = int(i_arr[k]), int(j_arr[k]), float(d_arr[k])
        ru, rv = uf.find(u), uf.find(v)
        if ru == rv:
            continue
        nu, nv = rep_node[ru], rep_node[rv]
        blu = max(0.0, w - height[nu])
        blv = max(0.0, w - height[nv])
        new = next_node
        next_node += 1
        children[new].append((nu, blu))
        children[new].append((nv, blv))
        height[new] = w
        rnew = uf.merge(ru, rv)
        rep_node[rnew] = new
    root = rep_node[uf.find(0)]
    return children, root


# Source: rabbittclust_tpu/post/trees.py::_leaf_name
def _leaf_name(ss, i: int) -> str:
    return ss.file_names[i] if ss.sketch_by_file else ss.names[i]


# Source: rabbittclust_tpu/post/trees.py::newick_string
def newick_string(ss, mst) -> str:
    n = len(ss)
    if n == 0:
        return ";"
    if n == 1:
        return _leaf_name(ss, 0) + ";"
    children, root = _agglomerate(n, mst)
    # iterative post-order build (avoids recursion limits on chains)
    out: List[str] = []

    def build(node: int) -> str:
        stack = [(node, False)]
        results = {}
        while stack:
            cur, done = stack.pop()
            if not children[cur]:
                results[cur] = _leaf_name(ss, cur)
                continue
            if not done:
                stack.append((cur, True))
                for ch, _bl in children[cur]:
                    stack.append((ch, False))
            else:
                parts = []
                for ch, bl in children[cur]:
                    parts.append(f"{results[ch]}:{bl:.6f}")
                results[cur] = "(" + ",".join(parts) + ")"
        return results[node]

    return build(root) + ";"


# Source: rabbittclust_tpu/post/trees.py::write_newick_tree
def write_newick_tree(ss, mst, output: str) -> None:
    with open(output, "w") as f:
        f.write(newick_string(ss, mst) + "\n")


# Source: rabbittclust_tpu/post/trees.py::write_phylip_tree
def write_phylip_tree(ss, mst, output: str) -> None:
    """PHYLIP: first line = number of trees (1), then the Newick tree."""
    with open(output, "w") as f:
        f.write("1\n" + newick_string(ss, mst) + "\n")


# Source: rabbittclust_tpu/post/trees.py::write_nexus_tree
def write_nexus_tree(ss, mst, output: str) -> None:
    tree = newick_string(ss, mst)
    with open(output, "w") as f:
        f.write("#NEXUS\n")
        f.write("BEGIN TAXA;\n")
        f.write(f"  DIMENSIONS NTAX={len(ss)};\n")
        f.write("  TAXLABELS")
        for i in range(len(ss)):
            lab = _leaf_name(ss, i).replace("'", "''")
            f.write(f" '{lab}'")
        f.write(";\n")
        f.write("END;\n")
        f.write("BEGIN TREES;\n")
        f.write(f"  TREE tree_1 = [&R] {tree}\n")
        f.write("END;\n")


# Source: rabbittclust_tpu/post/trees.py::linkage_matrix
def linkage_matrix(n: int, mst) -> List[Tuple[int, int, float, int]]:
    """scipy-style rows (c1, c2, dist, size) from MST Kruskal agglomeration
    (reference get_linkage_from_mst, MST.cpp:1241-1287)."""
    if n <= 1:
        return []
    i_arr, j_arr, d_arr = mst
    order = np.lexsort((j_arr, i_arr, d_arr))
    uf = UnionFind(n)
    cluster_id = list(range(n))
    cluster_size = [1] * (2 * n - 1)
    next_id = n
    rows = []
    for k in order:
        ru, rv = uf.find(int(i_arr[k])), uf.find(int(j_arr[k]))
        if ru == rv:
            continue
        id_u, id_v = cluster_id[ru], cluster_id[rv]
        new_id = next_id
        next_id += 1
        new_size = cluster_size[id_u] + cluster_size[id_v]
        rows.append((id_u, id_v, float(d_arr[k]), new_size))
        rnew = uf.merge(ru, rv)
        cluster_id[rnew] = new_id
        cluster_size[new_id] = new_size
    return rows


# Source: rabbittclust_tpu/post/trees.py::write_linkage_matrix
def write_linkage_matrix(n: int, mst, output: str) -> None:
    with open(output, "w") as f:
        for c1, c2, dist, size in linkage_matrix(n, mst):
            f.write(f"{c1}\t{c2}\t{dist:.6f}\t{size}\n")
