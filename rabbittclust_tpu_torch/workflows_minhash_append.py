"""MinHash (non --fast) append workflows for clust-mst / clust-greedy
(copied from ``rabbittclust_tpu/workflows_minhash_append.py``).

Reference semantics (sub_command.cpp append_clust_mst:1532+ /
append_clust_greedy:23-192):
  * state mode when the presketched folder holds a saved state
    (mst_cluster_state.bin / cluster_state.bin): new genomes are sketched
    WITHOUT saving, appended through the state machine on the host, the
    state is re-saved only when --save-rep is given again, and member names
    come from the folder's sketch metadata;
  * classic mode otherwise: pre + new sketches merged (size-sorted for
    greedy), full re-cluster on the device engines, combined artifacts
    written to a NEW timestamped run folder — the source folder is never
    mutated.  The JAX package's classic MST append runs the host
    ``compute_mst``; here it takes the dense engine with ``start_index``
    and the saved edges, as the KSSD append does (the same ``edge.mst``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .io.fasta import read_file_list
from .sketch.minhash import sketch_files_minhash, sketch_sequences_minhash
from .state import sketch_io
from .workflows import (
    OutputOptions,
    _compute_mst_engine,
    _mst_outputs,
    compute_minhash_clusters,
    log,
)


# Source: rabbittclust_tpu/workflows_minhash_append.py::_sketch_new
def _sketch_new(input_file, sketch_by_file, min_len, p, threads):
    if sketch_by_file:
        return sketch_files_minhash(read_file_list(input_file), min_len, p,
                                    threads)
    return sketch_sequences_minhash(input_file, min_len, p, threads)


# Source: rabbittclust_tpu/workflows_minhash_append.py::append_clust_mst
def append_clust_mst(folder_path: str, input_file: str, output_file: str,
                     sketch_by_file: bool, min_len: int, threshold: float,
                     threads: int, opts: OutputOptions,
                     device: torch.device, stats: Optional[dict] = None):
    state_file = os.path.join(folder_path, "mst_cluster_state.bin")
    if os.path.exists(state_file):
        from .sketch.minhash import MinHashParams
        from .state.mst_state import MstState
        st = MstState.load(state_file)
        mp = MinHashParams(kmer_size=st.kmer_size,
                           sketch_size=st.sketch_size,
                           is_containment=st.is_containment,
                           contain_compress=st.contain_compress)
        new_ss = _sketch_new(input_file, sketch_by_file, min_len, mp,
                             threads)
        live = st.append_cluster(new_ss)
        if not opts.no_save and opts.save_rep:
            st.save(state_file)
        st.write_cluster_result(live, output_file, st.threshold)
        log(f"-----write the cluster result into: {output_file}")
        return live, None
    ss, p = sketch_io.load_minhash_sketches(folder_path)
    pre_n = len(ss)
    new_ss = _sketch_new(input_file, sketch_by_file, min_len, p, threads)
    ss.extend(new_ss)
    pre_mst = None
    try:
        pre_mst = sketch_io.load_mst(folder_path)
    except FileNotFoundError:
        pre_n = 0
    res = _compute_mst_engine(ss, threshold, p.kmer_size, p.is_containment,
                              opts, device, stats,
                              start_index=pre_n if pre_mst else 0,
                              pre_edges=pre_mst)
    out_folder = folder_path
    if not opts.no_save:  # combined artifacts -> NEW run folder
        out_folder = sketch_io.default_folder_path()
        sketch_io.ensure_folder(out_folder)
        sketch_io.save_minhash_sketches(
            ss, out_folder, p.kmer_size, p.is_containment,
            p.contain_compress, p.sketch_size)
        sketch_io.save_genome_info(ss, out_folder, "mst", kssd=False)
        sketch_io.save_mst(res.mst, out_folder)
    return _mst_outputs(ss, res, threshold, output_file, opts, out_folder,
                        kssd=False)


# Source: rabbittclust_tpu/workflows_minhash_append.py::append_clust_greedy
def append_clust_greedy(folder_path: str, input_file: str, output_file: str,
                        sketch_by_file: bool, min_len: int, threshold: float,
                        threads: int, opts: OutputOptions,
                        device: torch.device, stats: Optional[dict] = None):
    state_file = os.path.join(folder_path, "cluster_state.bin")
    if os.path.exists(state_file):
        from .state.cluster_io import write_cluster_file
        from .state.greedy_state import MinHashClusterState
        st = MinHashClusterState.load(state_file)
        # rebuild sketches + metadata from the folder (the reference
        # reloads hash.sketch/info.sketch and rebuilds the rep index,
        # sub_command.cpp:100-160) — this also restores real names
        ss, p = sketch_io.load_minhash_sketches(folder_path)
        st.hashes = list(ss.hashes)
        st.file_names = list(ss.file_names)
        st.total_lens = list(ss.total_lens)
        st.names = list(ss.names)
        st.comments = list(ss.comments)
        st.build_inverted_index()
        new_ss = _sketch_new(input_file, sketch_by_file, min_len, p,
                             threads)
        clusters = st.incremental_cluster(new_ss)
        if not opts.no_save and opts.save_rep:
            st.save(state_file)
        ss.extend(new_ss)
        write_cluster_file(output_file, clusters, ss)
        log(f"-----write the cluster result into: {output_file}")
        log(f"-----the number of clusters is: {len(clusters)}")
        return clusters, ss
    ss, p = sketch_io.load_minhash_sketches(folder_path)
    new_ss = _sketch_new(input_file, sketch_by_file, min_len, p, threads)
    ss.extend(new_ss)
    out_folder = folder_path
    if not opts.no_save:  # combined sketches -> NEW run folder
        out_folder = sketch_io.default_folder_path()
        sketch_io.ensure_folder(out_folder)
        sketch_io.save_minhash_sketches(
            ss, out_folder, p.kmer_size, p.is_containment,
            p.contain_compress, p.sketch_size)
    return compute_minhash_clusters(ss, p, threshold, threads, output_file,
                                    opts, out_folder, "greedy", device,
                                    stats)
