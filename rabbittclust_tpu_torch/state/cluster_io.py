"""Cluster result text output — byte-compatible with the reference format.

Reference printKssdResult/printResult (src/MST_IO.cpp:72-179):
  optional header:
      # Clustering threshold: %.6f
      # Total clusters: %zu
      #
  per cluster:
      the cluster %d is: \n
      by-file rows:  \t%5d\t%6d\t%12dnt\t%20s\t%20s\t%s\n
                      (local_idx, global_idx, totalSeqLength, fileName,
                       firstSeqName, firstSeqComment)
      by-seq rows:   \t%6d\t%6d\t%12dnt\t%20s\t%s\n
                      (local_idx, global_idx, seqLength, seqName, comment)
      blank line after each cluster.
"""

from __future__ import annotations

from typing import List, Sequence

from ..utils.profiling import span


# Source: rabbittclust_tpu/state/cluster_io.py::format_cluster_result
def format_cluster_result(clusters: Sequence[Sequence[int]], sketches,
                          threshold: float = -1.0) -> str:
    out: List[str] = []
    if threshold >= 0.0:
        out.append(f"# Clustering threshold: {threshold:.6f}\n")
        out.append(f"# Total clusters: {len(clusters)}\n")
        out.append("#\n")
    by_file = sketches.sketch_by_file
    for ci, members in enumerate(clusters):
        out.append(f"the cluster {ci} is: \n")
        for li, gid in enumerate(members):
            if by_file:
                out.append("\t%5d\t%6d\t%12dnt\t%20s\t%20s\t%s\n" % (
                    li, gid, sketches.total_lens[gid],
                    sketches.file_names[gid], sketches.names[gid],
                    sketches.comments[gid]))
            else:
                out.append("\t%6d\t%6d\t%12dnt\t%20s\t%s\n" % (
                    li, gid, sketches.seq0_lens[gid], sketches.names[gid],
                    sketches.comments[gid]))
        out.append("\n")
    return "".join(out)


# Source: rabbittclust_tpu/state/cluster_io.py::write_cluster_file (the
# span write.cluster)
def write_cluster_file(path: str, clusters, sketches,
                       threshold: float = -1.0) -> None:
    with span("write.cluster"), open(path, "w") as f:
        f.write(format_cluster_result(clusters, sketches, threshold))
