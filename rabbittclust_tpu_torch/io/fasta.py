"""Pure-Python FASTA(.gz) reading for the size prescan (sketching reads
FASTA in the native library).

Yields (name, comment, seq_bytes) per record, mirroring kseq semantics:
name = header token up to first whitespace, comment = remainder.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List, Tuple


# Source: rabbittclust_tpu/io/fasta.py::_open
def _open(path: str):
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else f.read(2)
    if magic == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rb")
    f.seek(0)
    return f


# Source: rabbittclust_tpu/io/fasta.py::read_fasta
def read_fasta(path: str) -> Iterator[Tuple[str, str, bytes]]:
    name = None
    comment = ""
    chunks: List[bytes] = []
    with _open(path) as f:
        for raw in io.BufferedReader(f, 1 << 20):
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, comment, b"".join(chunks)
                header = line[1:].decode("utf-8", "replace")
                parts = header.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                chunks = []
            elif name is not None:
                chunks.append(line)
    if name is not None:
        yield name, comment, b"".join(chunks)


# Source: rabbittclust_tpu/io/fasta.py::read_file_list
def read_file_list(path: str) -> List[str]:
    """Genome list file: one path per line (reference SketchInfo.cpp:1001-1005)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                out.append(line)
    return out
