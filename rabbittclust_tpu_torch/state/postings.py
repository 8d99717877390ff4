"""The representative inverted index of the state files, written and read
a whole index at a time.

Every state of ``greedy_state.py`` and ``mst_state.py`` keeps its index as
``{hash: [rep index, ...]}`` and writes it as a count, then one record a
hash in ascending hash order: the hash (8 or 4 bytes), its posting count
(8 bytes) and the posting list (int32 each), all little-endian.  The JAX
package writes and reads that index one hash at a time in Python; these
functions give the same bytes and the same dict with NumPy over the whole
index.  Over a RepDB of 16,384 representatives (16,321,688 hashes) the
write takes 5.4 s against 51–56 s, the read 22 s against 44–48 s
(``scripts/state_index_times.py``, on a host of 8 cores).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import struct
from typing import Dict, List, Tuple

import numpy as np


@contextlib.contextmanager
def gc_paused():
    """The cyclic collector off inside the ``with``: making millions of
    small lists would otherwise run it again and again over all of them
    (none of them is part of a cycle)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def pack_postings(index: Dict[int, List[int]], key_bytes: int) -> bytes:
    """The index's bytes: ``<Q`` count, then per hash in ascending order
    the hash (``<Q`` or ``<I``), ``<Q`` posting count, ``<i4`` postings."""
    n = len(index)
    head = struct.pack("<Q", n)
    if n == 0:
        return head
    kw = key_bytes // 4  # the hash's 32-bit words
    keys = np.fromiter(index.keys(), dtype=np.uint64, count=n)
    if kw == 1 and int(keys.max()) >> 32:
        raise struct.error("a hash does not fit the index's 32-bit keys")
    lens = np.fromiter(map(len, index.values()), dtype=np.int64, count=n)
    vals = np.fromiter(itertools.chain.from_iterable(index.values()),
                       dtype=np.int32, count=int(lens.sum()))
    order = np.argsort(keys)
    src_off = np.cumsum(lens) - lens  # each list's first value in ``vals``
    keys, lens, src_off = keys[order], lens[order], src_off[order]
    words = kw + 2 + lens
    starts = np.cumsum(words) - words
    out = np.zeros(int(words.sum()), dtype="<u4")
    out[starts] = (keys & 0xFFFFFFFF).astype(np.uint32)
    if kw == 2:
        out[starts + 1] = (keys >> np.uint64(32)).astype(np.uint32)
    out[starts + kw] = lens.astype(np.uint32)  # the count's high word is 0
    within = np.arange(len(vals)) - np.repeat(np.cumsum(lens) - lens, lens)
    out[np.repeat(starts + kw + 2, lens) + within] = \
        vals[np.repeat(src_off, lens) + within].view(np.uint32)
    return head + out.tobytes()


def read_postings(data: bytes, off: int, key_bytes: int
                  ) -> Tuple[Dict[int, List[int]], int]:
    """The index ``pack_postings`` writes, read from ``data[off:]``, and the
    offset after it."""
    (n,) = struct.unpack_from("<Q", data, off)
    off += 8
    if n == 0:
        return {}, off
    kw = key_bytes // 4
    tail = (len(data) - off) // 4
    # one Python step a hash finds where each record starts (its posting
    # count fixes the next one's start); the rest is NumPy
    mv = memoryview(data)[off:off + 4 * tail].cast("I")
    starts = []
    add = starts.append
    p = 0
    for _ in range(n):
        add(p)
        p += kw + 2 + mv[p + kw]
    words = np.frombuffer(data, dtype="<u4", count=tail, offset=off)
    starts = np.asarray(starts, dtype=np.int64)
    if words[starts + kw + 1].any():
        raise ValueError("an inverted-index posting count exceeds 2^32")
    lens = words[starts + kw].astype(np.int64)
    keys = words[starts].astype(np.uint64)
    if kw == 2:
        keys |= words[starts + 1].astype(np.uint64) << np.uint64(32)
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
    vals = words[np.repeat(starts + kw + 2, lens) + within].view(
        np.int32).tolist()
    bounds = (np.cumsum(lens) - lens).tolist() + [len(vals)]
    with gc_paused():
        index = {k: vals[bounds[r]:bounds[r + 1]]
                 for r, k in enumerate(keys.tolist())}
    return index, off + 4 * p
