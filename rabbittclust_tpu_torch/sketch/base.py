"""The sketch-set container every engine of the port consumes: per-genome
sorted hash arrays plus genome metadata (reference analogue:
vector<KssdSketchInfo>, src/SketchInfo.h:23-56).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List

import numpy as np


# Source: rabbittclust_tpu/sketch/base.py::SketchSet (the KSSD container:
# no reordering helpers)
@dataclass
class SketchSet:
    kind: str                      # "kssd"
    params: Any                    # KssdParams
    sketch_by_file: bool
    use64: bool
    file_names: List[str] = field(default_factory=list)
    names: List[str] = field(default_factory=list)       # first-seq name per genome
    comments: List[str] = field(default_factory=list)    # first-seq comment
    seq0_lens: List[int] = field(default_factory=list)   # first-seq length
    total_lens: List[int] = field(default_factory=list)
    num_seqs: List[int] = field(default_factory=list)
    hashes: List[np.ndarray] = field(default_factory=list)  # sorted ascending
    # MinHash parameter sketch size per genome; zeros for KSSD sets
    param_sizes: List[int] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.hashes)

    def display_length(self, i: int) -> int:
        """Length printed in .cluster rows: total genome length in by-file
        mode, first-sequence length in by-sequence mode
        (reference src/MST_IO.cpp:105-127)."""
        return self.total_lens[i] if self.sketch_by_file else self.seq0_lens[i]

    def append_genome(self, *, file_name: str, name: str, comment: str,
                      seq0_len: int, total_len: int, num_seqs: int,
                      hashes: np.ndarray, param_size: int = 0) -> int:
        self.file_names.append(file_name)
        self.names.append(name)
        self.comments.append(comment)
        self.seq0_lens.append(seq0_len)
        self.total_lens.append(total_len)
        self.num_seqs.append(num_seqs)
        self.hashes.append(hashes)
        self.param_sizes.append(param_size)
        return len(self.hashes) - 1
