"""Array-backed union-find with path compression + union by rank
(reference src/UnionFind.h)."""

from __future__ import annotations

import numpy as np


# Source: rabbittclust_tpu/cluster/union_find.py::UnionFind
class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int8)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return int(root)

    def connected(self, a: int, b: int) -> bool:
        return self.find(a) == self.find(b)

    def merge(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return ra

    def roots_array(self) -> np.ndarray:
        """Vectorized full path compression; returns root per element."""
        p = self.parent
        while True:
            gp = p[p]
            if np.array_equal(gp, p):
                break
            p = gp
        self.parent = p.copy()
        return p
