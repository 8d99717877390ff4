"""Newick tree analyzer — self-contained equivalent of the reference's
benchmark/analysis/newick_analyzer.py (which requires Biopython; this one
has no dependencies and parses the quoted-label newick emitted by
post/trees.py as well as plain newick).

Capabilities (reference analyzer feature list, newick_analyzer.py:1-13):
basic stats, leaf listing, pairwise distances, nearest neighbors,
closest/farthest pairs, distance matrix, subtree extraction, ASCII tree,
greedy threshold clustering.

The port's copy of ``rabbittclust_tpu/evaltools/newick.py``.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from typing import Dict, List, Optional, Tuple


# Source: rabbittclust_tpu/evaltools/newick.py::Node
class Node:
    __slots__ = ("name", "length", "children", "parent", "depth")

    def __init__(self, name: str = "", length: float = 0.0):
        self.name = name
        self.length = length          # branch length to parent
        self.children: List["Node"] = []
        self.parent: Optional["Node"] = None
        self.depth = 0.0              # cumulative distance from root


# Source: rabbittclust_tpu/evaltools/newick.py::parse_newick
def parse_newick(text: str) -> Node:
    text = text.strip()
    if text.endswith(";"):
        text = text[:-1]
    pos = 0

    def read_label() -> str:
        nonlocal pos
        if pos < len(text) and text[pos] == "'":
            pos += 1
            out = []
            while pos < len(text):
                if text[pos] == "'":
                    if pos + 1 < len(text) and text[pos + 1] == "'":
                        out.append("'")
                        pos += 2
                        continue
                    pos += 1
                    break
                out.append(text[pos])
                pos += 1
            return "".join(out)
        start = pos
        while pos < len(text) and text[pos] not in ",():;":
            pos += 1
        return text[start:pos]

    def read_length() -> float:
        nonlocal pos
        if pos < len(text) and text[pos] == ":":
            pos += 1
            start = pos
            while pos < len(text) and text[pos] not in ",();":
                pos += 1
            return float(text[start:pos])
        return 0.0

    def subtree() -> Node:
        nonlocal pos
        node = Node()
        if pos < len(text) and text[pos] == "(":
            pos += 1
            while True:
                child = subtree()
                child.parent = node
                node.children.append(child)
                if pos < len(text) and text[pos] == ",":
                    pos += 1
                    continue
                break
            assert pos < len(text) and text[pos] == ")", \
                f"unbalanced newick at {pos}"
            pos += 1
            node.name = read_label()
        else:
            node.name = read_label()
        node.length = read_length()
        return node

    root = subtree()
    # annotate depths
    stack = [root]
    while stack:
        nd = stack.pop()
        for c in nd.children:
            c.depth = nd.depth + c.length
            stack.append(c)
    return root


# Source: rabbittclust_tpu/evaltools/newick.py::leaves
def leaves(root: Node) -> List[Node]:
    out = []
    stack = [root]
    while stack:
        nd = stack.pop()
        if nd.children:
            stack.extend(reversed(nd.children))
        else:
            out.append(nd)
    return out


# Source: rabbittclust_tpu/evaltools/newick.py::leaf_distance
def leaf_distance(a: Node, b: Node) -> float:
    """Path length between two leaves (walk to common ancestor)."""
    seen: Dict[int, float] = {}
    nd: Optional[Node] = a
    while nd is not None:
        seen[id(nd)] = nd.depth
        nd = nd.parent
    nd = b
    while nd is not None:
        if id(nd) in seen:
            return (a.depth - nd.depth) + (b.depth - nd.depth)
        nd = nd.parent
    raise ValueError("leaves not in the same tree")


# Source: rabbittclust_tpu/evaltools/newick.py::to_newick
def to_newick(nd: Node) -> str:
    def esc(name: str) -> str:
        if any(c in name for c in ",():; '"):
            return "'" + name.replace("'", "''") + "'"
        return name

    if not nd.children:
        return f"{esc(nd.name)}:{nd.length:.6f}"
    inner = ",".join(to_newick(c) for c in nd.children)
    lab = esc(nd.name) if nd.name else ""
    return f"({inner}){lab}:{nd.length:.6f}"


# Source: rabbittclust_tpu/evaltools/newick.py::extract_subtree
def extract_subtree(root: Node, names: List[str]) -> Node:
    """Induced subtree on the named leaves (unary internal nodes collapsed,
    branch lengths summed)."""
    want = set(names)

    def prune(nd: Node) -> Optional[Node]:
        if not nd.children:
            return nd if nd.name in want else None
        kept = [p for p in (prune(c) for c in nd.children) if p is not None]
        if not kept:
            return None
        if len(kept) == 1:
            kept[0].length += nd.length
            return kept[0]
        new = Node(nd.name, nd.length)
        new.children = kept
        for c in kept:
            c.parent = new
        return new

    out = prune(root)
    if out is None:
        raise ValueError("no requested leaves found in tree")
    out.length = 0.0
    out.parent = None
    stack = [out]
    out.depth = 0.0
    while stack:
        nd = stack.pop()
        for c in nd.children:
            c.depth = nd.depth + c.length
            stack.append(c)
    return out


# Source: rabbittclust_tpu/evaltools/newick.py::ascii_tree
def ascii_tree(root: Node, out=sys.stdout, max_leaves: int = 200) -> None:
    n_printed = [0]

    def rec(nd: Node, prefix: str, is_last: bool):
        if n_printed[0] > max_leaves:
            return
        connector = "└─" if is_last else "├─"
        label = nd.name if nd.name else "*"
        out.write(f"{prefix}{connector}{label} ({nd.length:.4f})\n")
        n_printed[0] += 1
        ext = "  " if is_last else "│ "
        for i, c in enumerate(nd.children):
            rec(c, prefix + ext, i == len(nd.children) - 1)

    out.write(f"{root.name or '*'}\n")
    for i, c in enumerate(root.children):
        rec(c, "", i == len(root.children) - 1)


# Source: rabbittclust_tpu/evaltools/newick.py::cluster_by_threshold
def cluster_by_threshold(root: Node, threshold: float
                         ) -> List[List[str]]:
    """Greedy threshold clustering over leaf path distances (reference
    newick_analyzer.py:343-403 semantics; seeds taken in leaf order)."""
    terms = leaves(root)
    remaining = list(terms)
    clusters: List[List[str]] = []
    while remaining:
        query = remaining.pop(0)
        cluster = [query.name]
        rest = []
        for t in remaining:
            if leaf_distance(query, t) < threshold:
                cluster.append(t.name)
            else:
                rest.append(t)
        remaining = rest
        clusters.append(cluster)
    return clusters


# Source: rabbittclust_tpu/evaltools/newick.py::basic_stats
def basic_stats(root: Node) -> Dict[str, float]:
    terms = leaves(root)
    n_int = 0
    total_bl = 0.0
    stack = [root]
    while stack:
        nd = stack.pop()
        total_bl += nd.length
        if nd.children:
            n_int += 1
            stack.extend(nd.children)
    return {
        "leaves": len(terms),
        "internal_nodes": n_int,
        "total_branch_length": total_bl,
        "max_depth": max((t.depth for t in terms), default=0.0),
    }


# Source: rabbittclust_tpu/evaltools/newick.py::main (--extract works on a
# tree of its own: extract_subtree reparents the leaves it keeps, so the
# original's later --ascii-tree / --cluster-threshold over the same tree
# fail or read the subtree)
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Newick tree analyzer (reference "
                    "benchmark/analysis/newick_analyzer.py equivalent)")
    p.add_argument("newick_file")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--list-leaves", type=int, metavar="N", default=0)
    p.add_argument("--neighbors", metavar="NAME")
    p.add_argument("--n-neighbors", type=int, default=10)
    p.add_argument("--pairwise", nargs=2, metavar=("A", "B"))
    p.add_argument("--closest-pairs", type=int, metavar="N", default=0)
    p.add_argument("--farthest-pairs", type=int, metavar="N", default=0)
    p.add_argument("--sample-size", type=int, default=100)
    p.add_argument("--distance-matrix", metavar="OUT")
    p.add_argument("--extract", nargs="+", metavar="NAME")
    p.add_argument("--extract-out", metavar="OUT")
    p.add_argument("--ascii-tree", action="store_true")
    p.add_argument("--cluster-threshold", type=float)
    p.add_argument("--cluster-out", metavar="OUT")
    args = p.parse_args(argv)

    with open(args.newick_file) as f:
        text = f.read()
    root = parse_newick(text)
    terms = leaves(root)
    by_name = {t.name: t for t in terms}

    if args.stats:
        for k, v in basic_stats(root).items():
            print(f"{k}: {v}")
    if args.list_leaves:
        for t in terms[:args.list_leaves]:
            print(t.name)
    if args.pairwise:
        a, b = args.pairwise
        print(f"distance({a}, {b}) = "
              f"{leaf_distance(by_name[a], by_name[b]):.6f}")
    if args.neighbors:
        q = by_name[args.neighbors]
        d = sorted(((leaf_distance(q, t), t.name) for t in terms
                    if t is not q))
        for dist, name in d[:args.n_neighbors]:
            print(f"{name}\t{dist:.6f}")
    if args.closest_pairs or args.farthest_pairs:
        sample = terms[:args.sample_size]
        pairs = sorted((leaf_distance(a, b), a.name, b.name)
                       for a, b in itertools.combinations(sample, 2))
        for d, a, b in pairs[:args.closest_pairs]:
            print(f"closest\t{a}\t{b}\t{d:.6f}")
        for d, a, b in pairs[::-1][:args.farthest_pairs]:
            print(f"farthest\t{a}\t{b}\t{d:.6f}")
    if args.distance_matrix:
        sample = terms[:args.sample_size] if args.sample_size else terms
        with open(args.distance_matrix, "w") as f:
            f.write("\t" + "\t".join(t.name for t in sample) + "\n")
            for a in sample:
                row = [f"{leaf_distance(a, b):.6f}" if a is not b else "0"
                       for b in sample]
                f.write(a.name + "\t" + "\t".join(row) + "\n")
        print(f"distance matrix written: {args.distance_matrix}")
    if args.extract:
        sub = extract_subtree(parse_newick(text), args.extract)
        text = to_newick(sub) + ";"
        if args.extract_out:
            with open(args.extract_out, "w") as f:
                f.write(text + "\n")
        else:
            print(text)
    if args.ascii_tree:
        ascii_tree(root)
    if args.cluster_threshold is not None:
        clusters = cluster_by_threshold(root, args.cluster_threshold)
        out = args.cluster_out or (args.newick_file +
                                   f".clusters_t{args.cluster_threshold}.txt")
        with open(out, "w") as f:
            for i, c in enumerate(clusters):
                f.write(f">Cluster_{i + 1} (size={len(c)})\n")
                for name in c:
                    f.write(name + "\n")
                f.write("\n")
        print(f"found {len(clusters)} clusters -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
