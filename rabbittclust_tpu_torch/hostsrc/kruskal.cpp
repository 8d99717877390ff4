// Kruskal's minimum spanning forest on the host, for
// cluster/mst.py::kruskal.
//
// The edges are ordered as np.lexsort((j, i, d)) orders them: by d, with
// -0.0 equal to 0.0 and every NaN last, then by i, then by j, then by
// position, which is where the stable lexsort leaves equal edges.  Each
// edge becomes a 24-byte record (d's order as an unsigned key, i << 32 | j,
// its position); the records are sorted in parallel (libstdc++'s parallel
// mode, over OpenMP) and walked with a union-find (path halving, union by
// rank) that stops at n - 1 kept edges.  Built with g++ by
// kernels/_build.py::build_host; a plain C interface, loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <parallel/algorithm>
#include <vector>

namespace {

struct Record {
  uint64_t key;  // d's order
  uint64_t ij;   // i << 32 | j: (i, j)'s order, as both lie below 2^32
  uint64_t pos;  // the edge's position in the input
};

inline bool operator<(const Record& a, const Record& b) {
  if (a.key != b.key) return a.key < b.key;
  if (a.ij != b.ij) return a.ij < b.ij;
  return a.pos < b.pos;
}

// An unsigned key in d's order: IEEE bits with the sign flipped for
// positives and every bit flipped for negatives; -0.0 takes +0.0's key and
// every NaN the largest, which no number reaches.
inline uint64_t order_key(double d) {
  if (d != d) return UINT64_MAX;
  if (d == 0.0) d = 0.0;
  uint64_t u;
  std::memcpy(&u, &d, sizeof u);
  return (u >> 63) ? ~u : (u | (uint64_t(1) << 63));
}

struct Forest {
  std::vector<uint32_t> parent;
  std::vector<uint8_t> rank;

  explicit Forest(int64_t n) : parent(n), rank(n, 0) {
    for (int64_t v = 0; v < n; ++v) parent[v] = uint32_t(v);
  }

  uint32_t find(uint32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }

  // True when a and b lay in two trees, which are then one.
  bool unite(uint32_t a, uint32_t b) {
    uint32_t ra = find(a), rb = find(b);
    if (ra == rb) return false;
    if (rank[ra] < rank[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    if (rank[ra] == rank[rb]) ++rank[ra];
    return true;
  }
};

}  // namespace

extern "C" {

// The kept edges' positions, in Kruskal's order, into kept (room for
// min(m, n - 1)); returns how many, or -1 when n is not in [0, 2^32) or an
// id lies outside [0, n).  presorted: walk the edges in the given order;
// d is then not read.
int64_t rtc_kruskal(const int64_t* ei, const int64_t* ej, const double* ed,
                    int64_t m, int64_t n, int presorted, int64_t* kept) {
  if (n < 0 || n > int64_t(UINT32_MAX)) return -1;
  int bad = 0;
#pragma omp parallel for reduction(| : bad)
  for (int64_t k = 0; k < m; ++k)
    bad |= ei[k] < 0 || ei[k] >= n || ej[k] < 0 || ej[k] >= n;
  if (bad) return -1;

  std::vector<Record> order;
  if (!presorted) {
    order.resize(m);
#pragma omp parallel for
    for (int64_t k = 0; k < m; ++k)
      order[k] = {order_key(ed[k]),
                  (uint64_t(ei[k]) << 32) | uint64_t(ej[k]), uint64_t(k)};
    __gnu_parallel::sort(order.begin(), order.end());
  }

  Forest forest(n);
  int64_t n_kept = 0;
  for (int64_t k = 0; k < m && n_kept < n - 1; ++k) {
    const int64_t p = presorted ? k : int64_t(order[k].pos);
    if (forest.unite(uint32_t(ei[p]), uint32_t(ej[p]))) kept[n_kept++] = p;
  }
  return n_kept;
}

}  // extern "C"
