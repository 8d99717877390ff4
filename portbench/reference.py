"""The plain reference: exact pair counts, the single-linkage partition at a
threshold and the minimum spanning forest of a KSSD corpus, in NumPy and
plain torch.

It imports nothing of the program and takes nothing the program made: only
the generated corpus (hash sets) and a grouping of its genomes, which is a
work plan and not an answer.  Every count is exact whatever the grouping:

- Two genomes of one group share only hashes that two members of the group
  hold, so a group's counts are one float32 product (TF32 off; sums below
  2^24 are exact) of its members' 0/1 incidence over those hashes.
- Two genomes of different groups share only *cross* hashes, held in more
  than one group.  A genome's cross hashes bound every count it has with
  another group; the pairs that could reach a count are counted exactly
  over their cross hashes.

Semantics (reference RabbitTClust, src/MST.cpp): the Mash distance
D = -(1/k) ln(2j / (1 + j)), j = c / (s0 + s1 - c), in float64 from exact
common counts c; k is the KSSD k-mer length 2 * ((k + 1) // 2).  The
threshold clusters are the components of the pairs with D <= d.  The MST
graph holds every pair with c >= 1 whose sizes pass the ratio gate
max <= R * min, R = int(2 e^{d (k - 1)} - 1).

``precision`` selects the control: ``float32`` computes every distance in
float32 (the step below the float64 that the configuration states);
``bits`` takes a pair's count from 8192-bit signatures (the buckets of
``hash & 8191`` that both genomes hold) in place of the exact count, as a
program that skipped the exact verify would.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

PRECISIONS = ("float64", "float32", "bits")
SIGNATURE_BITS = 8192
# rows of a group's count matrix computed at once: bounds the float32
# block (groups x rows x members) to 2^27 entries
BLOCK_ENTRIES = 1 << 27


def kssd_kmer(k: int) -> int:
    """The k-mer length KSSD's distances use: 2 * half_k."""
    return 2 * ((k + 1) // 2)


def ratio_limit(threshold: float, kmer: int) -> int:
    """R = int(2 e^{d (k - 1)} - 1) (reference src/MST.cpp)."""
    return int(2.0 * math.exp(threshold * (kmer - 1)) - 1.0)


def mash_distance(common, size0, size1, kmer: int,
                  dtype=np.float64) -> np.ndarray:
    """Mash distance from integer counts, every operation in ``dtype``."""
    dt = np.dtype(dtype).type
    c = np.asarray(common).astype(dt)
    s = np.asarray(size0).astype(dt) + np.asarray(size1).astype(dt)
    with np.errstate(divide="ignore", invalid="ignore"):
        j = np.where(s - c == 0, dt(0), c / np.maximum(s - c, dt(1)))
        core = -(dt(1.0) / dt(kmer)) * np.log(dt(2.0) * j / (dt(1.0) + j))
    return np.where(j == dt(1.0), dt(0.0), np.where(c == 0, dt(1.0), core))


def cmin_table(max_total: int, threshold: float, kmer: int,
               dtype=np.float64) -> np.ndarray:
    """c_min[S]: the least count c with D(c, S) <= threshold for a pair
    whose sizes sum to S (D depends on c and S alone and falls as c
    grows); S // 2 + 1 where none does."""
    dt = np.dtype(dtype).type
    out = np.empty(max_total + 1, dtype=np.int64)
    for s in range(max_total + 1):
        c = np.arange(1, s // 2 + 1)
        d = mash_distance(c, s - c, c, kmer, dtype)  # sizes sum to s
        ok = np.nonzero(d <= dt(threshold))[0]
        out[s] = c[ok[0]] if len(ok) else s // 2 + 1
    return out


@dataclass
class Plan:
    """The corpus on the device, grouped: its entries (genome, hash), the
    shared hashes of each group and the cross hashes."""
    n: int
    sizes: torch.Tensor          # (n,) int64
    group: torch.Tensor          # (n,) int64, groups numbered from 0
    member: torch.Tensor         # (n,) int64, index of a genome in its group
    group_sizes: np.ndarray      # (groups,) members of each group
    e_genome: torch.Tensor       # entries of a group's shared hashes: genome
    e_hash: torch.Tensor         #   and the group's local id of the hash
    n_local: torch.Tensor        # (groups,) shared hashes of each group
    ncross: torch.Tensor         # (n,) cross hashes of each genome
    x_genome: torch.Tensor       # entries of cross hashes, by hash: genome
    x_hash: torch.Tensor         #   and hash value
    flat: torch.Tensor           # every entry's hash, genome after genome
    genome: torch.Tensor         #   and its genome


def _runs(sorted_keys: torch.Tensor):
    """(start flag, run id, run length of each element) of equal keys."""
    new = torch.ones_like(sorted_keys, dtype=torch.bool)
    new[1:] = sorted_keys[1:] != sorted_keys[:-1]
    rid = torch.cumsum(new.long(), 0) - 1
    length = torch.bincount(rid)[rid]
    return new, rid, length


def make_plan(flat: np.ndarray, offsets: np.ndarray, group: np.ndarray,
              device: torch.device) -> Plan:
    """Sort the corpus's entries by (group, hash) and by hash on
    ``device``; find each group's shared hashes and the cross hashes."""
    n = len(offsets) - 1
    sizes = torch.as_tensor(np.diff(offsets), device=device)
    grp = torch.as_tensor(np.asarray(group, dtype=np.int64), device=device)
    genome = torch.repeat_interleave(torch.arange(n, device=device), sizes)
    h = torch.as_tensor(flat.astype(np.int64), device=device)
    g_e = grp[genome]

    order = torch.argsort(grp, stable=True)  # ascending ids in a group
    counts = torch.bincount(grp)
    starts = torch.cumsum(counts, 0) - counts
    member = torch.empty(n, dtype=torch.int64, device=device)
    member[order] = torch.arange(n, device=device) - starts[grp[order]]

    # a group's shared hashes: (group, hash) runs of two or more entries
    key, perm = torch.sort(g_e * (1 << 32) + h)
    new, _, length = _runs(key)
    shared = length >= 2
    first = new & shared
    gk = key >> 32
    rank = torch.cumsum(first.long(), 0) - 1
    n_local = torch.bincount(gk[first], minlength=len(counts))
    base = torch.cumsum(n_local, 0) - n_local
    e_genome = genome[perm][shared]
    e_hash = (rank - base[gk])[shared]
    del key, perm, new, length, shared, first, gk, rank

    # cross hashes: held in more than one group; by hash, then by group
    gsort = torch.argsort(g_e, stable=True)
    hsort = torch.argsort(h[gsort], stable=True)
    perm = gsort[hsort]
    del gsort, hsort
    key = h[perm]
    _, rid, _ = _runs(key)
    gs = g_e[perm]
    runs = int(rid[-1]) + 1 if len(rid) else 0
    lo = torch.full((runs,), 1 << 62, dtype=torch.int64, device=device)
    hi = torch.full_like(lo, -1)
    lo.scatter_reduce_(0, rid, gs, "amin")
    hi.scatter_reduce_(0, rid, gs, "amax")
    cross = (lo != hi)[rid]
    x_genome = genome[perm][cross]
    x_hash = key[cross]
    ncross = torch.bincount(x_genome, minlength=n)
    return Plan(n=n, sizes=sizes, group=grp, member=member,
                group_sizes=counts.cpu().numpy(), e_genome=e_genome,
                e_hash=e_hash, n_local=n_local, ncross=ncross,
                x_genome=x_genome, x_hash=x_hash, flat=h, genome=genome)


def _batches(plan: Plan):
    """Groups of two or more members in batches of one padded size: a group
    of 1,024 or more alone, smaller ones by the power of two above."""
    sizes = plan.group_sizes
    pad = np.where(sizes >= 1024, sizes,
                   1 << np.ceil(np.log2(np.maximum(sizes, 1))).astype(int))
    for p in np.unique(pad[sizes >= 2]):
        ids = np.nonzero((pad == p) & (sizes >= 2))[0]
        if p >= 1024:
            for g in ids:
                yield np.array([g]), int(p)
        else:
            yield ids, int(p)


@dataclass
class Batch:
    """A batch of groups padded to ``pad`` members: the batch slot of each
    group (-1 outside it), each slot's genome ids (-1 on padding) and
    sizes (0 on padding)."""
    gids: np.ndarray
    pad: int
    slot: torch.Tensor
    gid: torch.Tensor
    size: torch.Tensor


def _batch(plan: Plan, gids: np.ndarray, pad: int) -> Batch:
    dev = plan.sizes.device
    slot = torch.full((len(plan.group_sizes),), -1, dtype=torch.int64,
                      device=dev)
    slot[torch.as_tensor(gids, device=dev)] = torch.arange(len(gids),
                                                           device=dev)
    s = slot[plan.group]
    sel = torch.nonzero(s >= 0).squeeze(1)
    gid = torch.full((len(gids), pad), -1, dtype=torch.int64, device=dev)
    gid[s[sel], plan.member[sel]] = sel
    size = torch.zeros((len(gids), pad), dtype=torch.int64, device=dev)
    size[s[sel], plan.member[sel]] = plan.sizes[sel]
    return Batch(gids=gids, pad=pad, slot=slot, gid=gid, size=size)


def _incidence(plan: Plan, b: Batch, precision: str) -> torch.Tensor:
    """(groups, pad, width) float32 0/1 incidence of the batch's members
    over their group's shared hashes, or over the signature's buckets."""
    dev = plan.sizes.device
    if precision == "bits":
        s = b.slot[plan.group[plan.genome]]
        sel = s >= 0
        x = torch.zeros((len(b.gids), b.pad, SIGNATURE_BITS),
                        dtype=torch.float32, device=dev)
        x[s[sel], plan.member[plan.genome[sel]],
          plan.flat[sel] & (SIGNATURE_BITS - 1)] = 1.0
        return x
    width = max(int(plan.n_local[torch.as_tensor(b.gids, device=dev)].max()),
                1)
    s = b.slot[plan.group[plan.e_genome]]
    sel = s >= 0
    x = torch.zeros((len(b.gids), b.pad, width), dtype=torch.float32,
                    device=dev)
    x[s[sel], plan.member[plan.e_genome[sel]], plan.e_hash[sel]] = 1.0
    return x


def _group_counts(plan: Plan, precision: str):
    """Yield (batch, row0, counts (groups, rows, pad) int32): every
    within-group count, in blocks of rows."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for gids, pad in _batches(plan):
            b = _batch(plan, gids, pad)
            x = _incidence(plan, b, precision)
            rows = max(1, min(pad, BLOCK_ENTRIES // (len(gids) * pad)))
            for r0 in range(0, pad, rows):
                c = torch.bmm(x[:, r0:r0 + rows], x.transpose(1, 2))
                yield b, r0, c.round_().int()
            del x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _components(adj: torch.Tensor) -> torch.Tensor:
    """(groups, pad) least member index of each member's component under a
    (groups, pad, pad) bool adjacency: rounds in which every member takes
    the least label among itself and its neighbours, each followed by
    shortcuts of labels to their labels' labels, until none moves."""
    g, pad, _ = adj.shape
    labels = torch.arange(pad, dtype=torch.int64,
                          device=adj.device).repeat(g, 1)
    rows = max(1, min(pad, BLOCK_ENTRIES // (g * pad)))
    big = pad
    while True:
        new = labels.clone()
        for r0 in range(0, pad, rows):
            nb = torch.where(adj[:, r0:r0 + rows], labels[:, None, :],
                             big).amin(2)
            new[:, r0:r0 + rows] = torch.minimum(new[:, r0:r0 + rows], nb)
        while True:
            nxt = torch.gather(new, 1, new)
            if torch.equal(nxt, new):
                break
            new = nxt
        if torch.equal(new, labels):
            return labels
        labels = new


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, a: int) -> int:
        p = self.parent
        while p[a] != a:
            p[a] = p[p[a]]
            a = p[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def _pass_table(plan: Plan, threshold, kmer, precision):
    dtype = np.float32 if precision == "float32" else np.float64
    return torch.as_tensor(
        cmin_table(2 * int(plan.sizes.max()), threshold, kmer, dtype),
        device=plan.sizes.device)


def cross_pairs(plan: Plan):
    """(i, j, count), i < j, of every pair in different groups that shares
    a cross hash: within each hash's holders (ordered by group), each
    holder against the holders of the later groups."""
    dev = plan.sizes.device
    g, h = plan.x_genome, plan.x_hash
    if len(g) == 0:
        e = torch.empty(0, dtype=torch.int64, device=dev)
        return e, e.clone(), e.clone()
    grp = plan.group[g]
    _, rid, _ = _runs(h)
    _, bid, _ = _runs(h * (1 << 32) + grp)
    pos = torch.arange(len(g), device=dev)
    run_end = torch.zeros(int(rid[-1]) + 1, dtype=torch.int64, device=dev)
    run_end.scatter_reduce_(0, rid, pos + 1, "amax")
    blk_end = torch.zeros(int(bid[-1]) + 1, dtype=torch.int64, device=dev)
    blk_end.scatter_reduce_(0, bid, pos + 1, "amax")
    count = run_end[rid] - blk_end[bid]
    x = torch.repeat_interleave(pos, count)
    off = torch.arange(len(x), device=dev) - torch.repeat_interleave(
        torch.cumsum(count, 0) - count, count)
    y = blk_end[bid][x] + off
    gi, gj = g[x], g[y]
    key = torch.minimum(gi, gj) * plan.n + torch.maximum(gi, gj)
    key, cnt = torch.unique(key, return_counts=True)
    return key // plan.n, key % plan.n, cnt


def partition(plan: Plan, threshold: float, kmer: int,
              precision: str = "float64") -> np.ndarray:
    """The component label (its least genome id) of every genome under the
    pairs with D <= threshold."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    dev = plan.sizes.device
    cmin = _pass_table(plan, threshold, kmer, precision)
    labels = torch.arange(plan.n, device=dev)
    adj = None
    for b, r0, c in _group_counts(plan, precision):
        if r0 == 0:
            if adj is not None:
                _label(prev, adj, labels)
            adj = torch.zeros((len(b.gids), b.pad, b.pad), dtype=torch.bool,
                              device=dev)
            prev = b
        rows = c.shape[1]
        si = b.size[:, r0:r0 + rows, None]
        sj = b.size[:, None, :]
        adj[:, r0:r0 + rows] = (c >= cmin[si + sj]) & (si > 0) & (sj > 0)
    if adj is not None:
        _label(prev, adj, labels)
    labels = labels.cpu().numpy()
    # pairs across groups: a pair's count is at most either genome's cross
    # hashes, and c_min grows with the sizes' sum
    smin = int(plan.sizes.min())
    need = int(cmin[2 * smin]) if 2 * smin < len(cmin) else 1
    if bool((plan.ncross >= need).any()):
        i, j, cnt = cross_pairs(plan)
        s = plan.sizes
        ok = cnt >= cmin[s[i] + s[j]]
        uf = _UnionFind(plan.n)
        for a, b_ in zip(i[ok].tolist(), j[ok].tolist()):
            uf.union(int(labels[a]), int(labels[b_]))
        roots = np.unique(labels)
        root_of = {r: uf.find(int(r)) for r in roots.tolist()}
        labels = np.vectorize(root_of.get)(labels) if root_of else labels
    return labels


def _label(b: Batch, adj: torch.Tensor, labels: torch.Tensor) -> None:
    """Write the least genome id of each member's component into
    ``labels``."""
    adj &= ~torch.eye(b.pad, dtype=torch.bool, device=adj.device)
    local = _components(adj)
    root = torch.gather(b.gid, 1, local)
    real = b.gid >= 0
    labels[b.gid[real]] = root[real]


@dataclass
class Forest:
    """The reference's MST graph and one minimum spanning forest of it."""
    n: int
    keys: np.ndarray         # sorted i * n + j (i < j) of every graph edge
    weights: np.ndarray      # their distances
    mst_keys: np.ndarray     # the forest's edges, keyed as ``keys``
    mst_weights: np.ndarray  # the forest's weights, ascending
    components: int


def graph_edges(plan: Plan, threshold: float, kmer: int,
                precision: str = "float64"):
    """(keys, weights): every pair with a common hash that passes the
    ratio gate, keyed i * n + j with i < j, ascending."""
    radio = ratio_limit(threshold, kmer)
    keys, cs = [], []
    for b, r0, c in _group_counts(plan, precision):
        bb, ii, jj = torch.nonzero(c >= 1, as_tuple=True)
        gi, gj = b.gid[bb, ii + r0], b.gid[bb, jj]
        up = (gi >= 0) & (gj >= 0) & (gi < gj)
        keys.append(gi[up] * plan.n + gj[up])
        cs.append(c[bb[up], ii[up], jj[up]].long())
    i, j, cnt = cross_pairs(plan)
    keys.append(i * plan.n + j)
    cs.append(cnt)
    key = torch.cat(keys)
    cnt = torch.cat(cs)
    order = torch.argsort(key)
    key, cnt = key[order], cnt[order]
    s = plan.sizes
    i, j = key // plan.n, key % plan.n
    ok = torch.maximum(s[i], s[j]) <= radio * torch.minimum(s[i], s[j])
    key, cnt, i, j = key[ok], cnt[ok], i[ok], j[ok]
    dtype = np.float32 if precision == "float32" else np.float64
    w = mash_distance(cnt.cpu().numpy(), s[i].cpu().numpy(),
                      s[j].cpu().numpy(), kmer, dtype).astype(np.float64)
    return key.cpu().numpy(), w


def boruvka(n: int, keys: np.ndarray, weights: np.ndarray,
            device: torch.device) -> np.ndarray:
    """Indices into ``keys`` of one minimum spanning forest: Boruvka's
    rounds over edges ranked by (weight, key), so that no two tie."""
    if len(keys) == 0:
        return np.empty(0, dtype=np.int64)
    order_np = np.lexsort((keys, weights))
    rank = np.empty(len(keys), dtype=np.int64)
    rank[order_np] = np.arange(len(keys))
    order = torch.as_tensor(order_np, device=device)
    u = torch.as_tensor(keys // n, device=device)
    v = torch.as_tensor(keys % n, device=device)
    r = torch.as_tensor(rank, device=device)
    ids = torch.arange(n, device=device)
    comp = ids.clone()
    chosen = []
    none = len(keys)
    while True:
        cu, cv = comp[u], comp[v]
        live = cu != cv
        if not bool(live.any()):
            break
        best = torch.full((n,), none, dtype=torch.int64, device=device)
        best.scatter_reduce_(0, cu[live], r[live], "amin")
        best.scatter_reduce_(0, cv[live], r[live], "amin")
        has = torch.nonzero(best < none).squeeze(1)
        e = order[best[has]]
        chosen.append(e)
        # each component hooks to the other end of its least edge; of two
        # that chose one edge, the lesser id stays a root
        parent = ids.clone()
        parent[has] = torch.where(cu[e] == has, cv[e], cu[e])
        mutual = (parent[parent] == ids) & (ids < parent)
        parent = torch.where(mutual, ids, parent)
        while True:
            nxt = parent[parent]
            if torch.equal(nxt, parent):
                break
            parent = nxt
        comp = parent[comp]
    if not chosen:
        return np.empty(0, dtype=np.int64)
    return torch.unique(torch.cat(chosen)).cpu().numpy()


def forest(plan: Plan, threshold: float, kmer: int,
           precision: str = "float64") -> Forest:
    keys, w = graph_edges(plan, threshold, kmer, precision)
    sel = boruvka(plan.n, keys, w, plan.sizes.device)
    return Forest(n=plan.n, keys=keys, weights=w, mst_keys=keys[sel],
                  mst_weights=np.sort(w[sel]),
                  components=plan.n - len(sel))
