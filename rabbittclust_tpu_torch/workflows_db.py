"""build_kssd_db_fast: reusable sketch+index database folder
(reference sub_command.cpp:2224-2300), copied from
``rabbittclust_tpu/workflows_db.py``; host code (native KSSD sketching).

Accepts either a genome list or a previous ``.cluster``/``.cluster.dedup``
file (genome file paths are extracted from the 4th column of cluster rows).
"""

from __future__ import annotations

import os
import sys
from typing import List

from .io.fasta import read_file_list
from .sketch.kssd import sketch_files_kssd
from .state import sketch_io


# Source: rabbittclust_tpu/workflows_db.py::extract_paths_from_cluster_file
def extract_paths_from_cluster_file(path: str) -> List[str]:
    """Pull genome file paths out of a by-file .cluster output."""
    out: List[str] = []
    seen = set()
    with open(path) as f:
        for line in f:
            if not line.startswith("\t"):
                continue
            cols = line.rstrip("\n").split("\t")
            # by-file rows: idx, gid, <len>nt, fileName, seqName, comment;
            # columns after split: ['', idx, gid, len, file, name, comment]
            if len(cols) >= 5:
                fn = cols[4].strip()
                if fn and fn not in seen:
                    seen.add(fn)
                    out.append(fn)
    return out


# Source: rabbittclust_tpu/workflows_db.py::build_kssd_db_fast
def build_kssd_db_fast(input_file: str, db_folder: str, is_set_kmer: bool,
                       is_containment: bool, min_len: int, kmer_size: int,
                       drlevel: int, threads: int) -> None:
    # Decide whether the input is a cluster file or a plain genome list.
    files: List[str] = []
    with open(input_file) as f:
        head = f.read(4096)
    # NOTE: the reference's detector (looks_like_cluster_result_file,
    # sub_command.cpp:2224-2238) only tests whether the FIRST non-blank line
    # starts with "the cluster", so headered cluster files (with the
    # "# Clustering threshold" banner) crash it; we accept both forms.
    if "the cluster" in head or head.startswith("# Clustering threshold"):
        files = extract_paths_from_cluster_file(input_file)
        print(f"-----buildDB: extracted genome paths from cluster file "
              f"({len(files)})", file=sys.stderr)
    else:
        files = read_file_list(input_file)
    if not files:
        raise ValueError(f"no genome paths found in {input_file}")
    from .workflows import tune_kssd_parameters
    # write the file list for tuning (cal_size expects a list file);
    # same name/layout as the reference's materialized list (builddb.list)
    tmp_list = input_file
    if files != read_file_list(input_file):
        tmp_list = os.path.join(db_folder, "builddb.list")
        os.makedirs(db_folder, exist_ok=True)
        with open(tmp_list, "w") as f:
            f.write("\n".join(files) + "\n")
    tuned = tune_kssd_parameters(True, is_set_kmer, tmp_list, threads,
                                 min_len, is_containment, kmer_size, 0.05,
                                 drlevel)
    ss, p = sketch_files_kssd(files, min_len, tuned.kmer_size, drlevel,
                              threads)
    sketch_io.ensure_folder(db_folder)
    sketch_io.save_kssd_sketches(ss, p, db_folder)
    sketch_io.save_kssd_index(ss.hashes, ss.use64, db_folder)
    print(f"-----built KSSD sketch+index DB with {len(ss)} genomes into: "
          f"{db_folder}", file=sys.stderr)
