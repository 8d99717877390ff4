"""The backend-free host code of ``rabbittclust_tpu`` that the port shares.

Sketching (native KSSD), distances, Kruskal, forest cuts, persistence and
the clust-mst output tail are imported from the JAX package, not copied;
none of these modules imports ``jax``.  Gathering them here names the
port's whole dependency on the reference package in one place.
"""

from rabbittclust_tpu import workflows as shared_wf
from rabbittclust_tpu.cli.common import (
    base_parser,
    make_output_options,
    validate_common,
)
from rabbittclust_tpu.cluster.mst import (
    DENSE_SPAN,
    Edges,
    MstResult,
    clusters_from_forest,
    compute_mst,
    concat_edges,
    cut_forest,
    kruskal,
    sort_edges,
)
from rabbittclust_tpu.cluster.union_find import UnionFind
from rabbittclust_tpu.distance.mash import (
    aaf_distance,
    mash_distance,
    min_jaccard_for_threshold,
    size_ratio_limit,
)
from rabbittclust_tpu.io.fasta import read_file_list
from rabbittclust_tpu.ops.bitmap import (
    CsrSketches,
    _decode_packed_mask,
    pack_bitmaps_packed,
)
from rabbittclust_tpu.ops.cluster_fast import (
    _gated_verify_block,
    gated_verify_merge,
    labels_from_clusters,
)
from rabbittclust_tpu.ops.labelprop import SENT, _encode_clear, _lp_fallback
from rabbittclust_tpu.ops.pack import PackedSketches, pack_sketches
from rabbittclust_tpu.sketch.base import SketchSet
from rabbittclust_tpu.sketch.kssd import (
    KssdParams,
    sketch_files_kssd,
    sketch_sequences_kssd,
)
from rabbittclust_tpu.state import sketch_io
from rabbittclust_tpu.state.cluster_io import write_cluster_file
from rabbittclust_tpu.utils.native import (
    load_native,
    native_intra_mst,
    native_mst,
)
from rabbittclust_tpu.utils.timers import Timer

__all__ = [
    "DENSE_SPAN", "CsrSketches", "Edges", "KssdParams", "MstResult",
    "PackedSketches", "SENT", "SketchSet", "Timer", "UnionFind",
    "_decode_packed_mask", "_encode_clear", "_gated_verify_block",
    "_lp_fallback", "aaf_distance", "base_parser", "clusters_from_forest",
    "compute_mst", "concat_edges", "cut_forest", "gated_verify_merge",
    "kruskal", "labels_from_clusters", "load_native", "make_output_options",
    "mash_distance", "min_jaccard_for_threshold", "native_intra_mst",
    "native_mst", "pack_bitmaps_packed", "pack_sketches", "read_file_list",
    "shared_wf", "size_ratio_limit", "sketch_files_kssd", "sketch_io",
    "sketch_sequences_kssd", "sort_edges", "validate_common",
    "write_cluster_file",
]
