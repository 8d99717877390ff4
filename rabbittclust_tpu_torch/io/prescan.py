"""Input pre-scan — the reference calSize() (src/SketchInfo.cpp:438-552).

Computes max/min/average genome size used by parameter auto-tuning.
By-file mode uses the file size from stat() (gz: ISIZE field = last 4 bytes),
by-sequence mode scans sequence lengths.
"""

from __future__ import annotations

import os
import struct
import sys
from typing import Tuple

from .fasta import read_fasta, read_file_list


# Source: rabbittclust_tpu/io/prescan.py::cal_size
def cal_size(sketch_by_file: bool, input_file: str, threads: int,
             min_len: int) -> Tuple[int, int, int]:
    """Returns (max_size, min_size, average_size)."""
    max_size = 0
    min_size = 1 << 31
    total_size = 0
    number = 0
    bad_number = 0
    if sketch_by_file:
        for line in read_file_list(input_file):
            if line.endswith("gz"):
                # gzip ISIZE trick (reference SketchInfo.cpp:456-464):
                # uncompressed size mod 2^32 is stored in the last 4 bytes.
                with open(line, "rb") as f:
                    f.seek(-4, os.SEEK_END)
                    cur = struct.unpack("<I", f.read(4))[0]
            else:
                cur = os.stat(line).st_size
            if cur < min_len:
                bad_number += 1
                continue
            max_size = max(max_size, cur)
            min_size = min(min_size, cur)
            total_size += cur
            number += 1
    else:
        for _, _, seq in read_fasta(input_file):
            length = len(seq)
            if length < min_len:
                bad_number += 1
                continue
            max_size = max(max_size, length)
            min_size = min(min_size, length)
            total_size += length
            number += 1
    if number == 0:
        raise ValueError(
            f"no genomes above min length {min_len} in {input_file}")
    average_size = total_size // number
    total_number = number + bad_number
    print(f"\t===the genome number for clustering is: {number}", file=sys.stderr)
    print(f"\t===the genome number below the minimum genome length threshold "
          f"is: {bad_number}", file=sys.stderr)
    print(f"\t===the total genome number is: {total_number}", file=sys.stderr)
    if total_number and bad_number / total_number >= 0.2:
        print(f"Warning: there are {bad_number} poor quality (length < "
              f"{min_len}) genome assemblies in the total {total_number} "
              f"genome assemblied.", file=sys.stderr)
    print(f"\t===the totalSize is: {total_size}", file=sys.stderr)
    print(f"\t===the maxSize is: {max_size}", file=sys.stderr)
    print(f"\t===the minSize is: {min_size}", file=sys.stderr)
    print(f"\t===the averageSize is: {average_size}", file=sys.stderr)
    return max_size, min_size, average_size
