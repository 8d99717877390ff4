#!/usr/bin/env python
"""Time the state files' inverted index, built, written and read two ways,
over the index of a RepDB file (``REPDB002``):

* ``hash by hash`` — the JAX package's code (``rabbittclust_tpu/state/
  greedy_state.py``: ``build_inverted_index`` with ``_index_add``,
  ``_write_index``, ``_read_index``), copied here as it is; the port
  builds its index with this code too;
* ``whole`` — NumPy over the whole index: the port's
  ``rabbittclust_tpu_torch/state/postings.py`` (``pack_postings``,
  ``read_postings``) for the write and the read, and for the build
  ``build_sorted`` below (a stable sort of every posting by hash, then one
  list a hash), which the port does not use: it gains nothing on the
  build.

Each pair is held equal (the same dict, the same bytes) and timed on the
host clock in turns (hash by hash, whole, whole, hash by hash at
``--turns 2``).  The whole ``load_repdb`` of the file is timed first.
Host code only: no device is used.

Usage:
    python scripts/state_index_times.py REPDB [--turns 2]
A RepDB of the size of chip_smoke.py's phase 18a is made by
``clust-greedy --fast --device --db rep.db --build --presketched <folder>``
over a folder of 32,768 sketches.
"""

import argparse
import gc
import io
import os
import platform
import struct
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rabbittclust_tpu_torch.state.greedy_state import (  # noqa: E402
    KssdClusterState)
from rabbittclust_tpu_torch.state.postings import (  # noqa: E402
    gc_paused, pack_postings, read_postings)


# Source: rabbittclust_tpu/state/greedy_state.py::KssdClusterState.build_inverted_index
def build_by_hash(rep_hashes):
    idx = {}
    for rep_idx, h in enumerate(rep_hashes):
        # Source: rabbittclust_tpu/state/greedy_state.py::KssdClusterState._index_add
        for hv in h.tolist():
            lst = idx.get(hv)
            if lst is None:
                idx[hv] = [rep_idx]
            else:
                lst.append(rep_idx)
    return idx


# Source: rabbittclust_tpu/state/greedy_state.py::KssdClusterState._write_index
def write_by_hash(index, f):
    f.write(struct.pack("<Q", len(index)))
    for hv in sorted(index):
        lst = index[hv]
        f.write(struct.pack("<Q", hv))
        f.write(struct.pack("<Q", len(lst)))
        f.write(np.asarray(lst, dtype="<i4").tobytes())


# Source: rabbittclust_tpu/state/greedy_state.py::KssdClusterState._read_index
def read_by_hash(data, off, key64):
    (n,) = struct.unpack_from("<Q", data, off); off += 8
    idx = {}
    for _ in range(n):
        if key64:
            (hv,) = struct.unpack_from("<Q", data, off); off += 8
        else:
            (hv,) = struct.unpack_from("<I", data, off); off += 4
        (m,) = struct.unpack_from("<Q", data, off); off += 8
        idx[hv] = np.frombuffer(data, dtype="<i4", count=m,
                                offset=off).tolist()
        off += 4 * m
    return idx, off


def build_sorted(hash_lists):
    """The dict ``build_by_hash`` builds, from one stable sort of every
    posting by hash."""
    sizes = np.fromiter((len(h) for h in hash_lists), dtype=np.int64,
                        count=len(hash_lists))
    if not sizes.sum():
        return {}
    flat = np.concatenate([np.asarray(h) for h in hash_lists if len(h)])
    owner = np.repeat(np.arange(len(hash_lists), dtype=np.int64), sizes)
    order = np.argsort(flat, kind="stable")
    flat = flat[order]
    owners = owner[order].tolist()
    first = np.flatnonzero(np.concatenate(([True], flat[1:] != flat[:-1])))
    bounds = first.tolist() + [len(owners)]
    with gc_paused():
        return {k: owners[bounds[r]:bounds[r + 1]]
                for r, k in enumerate(flat[first].tolist())}


def timed(fn):
    gc.collect()
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def write_whole(index, f):
    f.write(pack_postings(index, 8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("repdb")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    load_s, st = timed(lambda: KssdClusterState.load_repdb(args.repdb))
    reps = [st.hashes[g] for g in st.representative_ids]
    n_post = sum(len(h) for h in reps)
    print(f"{args.repdb}: {len(reps)} representatives, "
          f"{len(st.inverted_index)} hashes, {n_post} postings, "
          f"{os.path.getsize(args.repdb)} B; load_repdb {load_s:.3f} s; "
          f"host {platform.processor() or platform.machine()}, "
          f"{os.cpu_count()} cores, Python {platform.python_version()}")
    del st
    pair = ["hash by hash", "whole"]
    order = [w for t in range(args.turns)
             for w in (pair if t % 2 == 0 else pair[::-1])]
    times = {(s, w): [] for s in ("build", "write", "read") for w in order}
    ref = {}
    for way in order:
        build = build_by_hash if way == "hash by hash" else build_sorted
        t, index = timed(lambda: build(reps))
        times["build", way].append(t)
        ref.setdefault("index", index)
        assert index == ref["index"], f"build ({way}) differs"
        write = write_by_hash if way == "hash by hash" else write_whole
        buf = io.BytesIO()
        t, _ = timed(lambda: write(index, buf))
        times["write", way].append(t)
        data = buf.getvalue()
        ref.setdefault("bytes", data)
        assert data == ref["bytes"], f"write ({way}) differs"
        del index, buf
        read = read_by_hash if way == "hash by hash" else \
            (lambda d, o, k: read_postings(d, o, 8 if k else 4))
        t, (back, end) = timed(lambda: read(data, 0, True))
        times["read", way].append(t)
        assert end == len(data) and back == ref["index"], \
            f"read ({way}) differs"
        del back, data
    for (stage, way), ts in times.items():
        print(f"{stage:5s} {way:12s} " +
              " ".join(f"{t:.6f}" for t in ts) + " s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
