"""RepDB verb dispatch (--db --build/--query/--assign/--append/--stats),
copied from ``rabbittclust_tpu/cli/repdb.py``.

Output TSV formats match the reference exactly
(sub_command.cpp:337-450 query/assign writers).  Two verbs have a device
program and run it on the CLI's device (``None``: cuda:0, raising without
a GPU) whether or not ``--device`` is given: the greedy KSSD ``--query``
probes the RepDB through K1 (``state/greedy_state.py::batch_query_device``;
the JAX package does so only under ``--device``), and the MST ``--build``
takes the dense engine (K4's mask mode, K5b) in place of the host
``compute_mst``.  The others run on the host, as in the JAX package.
"""

from __future__ import annotations

import sys

from ..device import resolve_device
from ..io.fasta import read_file_list
from ..sketch.kssd import sketch_files_kssd, sketch_sequences_kssd
from ..state.greedy_state import KssdClusterState


# Source: rabbittclust_tpu/cli/repdb.py::_sketch_queries
def _sketch_queries(args, kmer_size: int, drlevel: int):
    if args.sketch_by_file:
        files = read_file_list(args.input)
        ss, _ = sketch_files_kssd(files, args.min_len, kmer_size, drlevel,
                                  args.threads)
    else:
        ss, _ = sketch_sequences_kssd(args.input, args.min_len, kmer_size,
                                      drlevel, args.threads)
    return ss


# Source: rabbittclust_tpu/cli/repdb.py::_query_name
def _query_name(ss, i: int) -> str:
    name = ss.file_names[i] if ss.sketch_by_file else ss.names[i]
    return name or f"query_{i}"


# Source: rabbittclust_tpu/cli/repdb.py::write_query_tsv
def write_query_tsv(state, ss, output_file: str, topk: int,
                    precomputed=None) -> None:
    """``precomputed`` (one hit list per query) replaces the serial
    query_topk loop — the device and multihost probes supply it."""
    with open(output_file, "w") as fp:
        fp.write("#query\trank\trep_name\tdistance\tcluster_id\t"
                 "cluster_size\n")
        for i in range(len(ss)):
            results = precomputed[i] if precomputed is not None \
                else state.query_topk(ss.hashes[i], topk)
            qname = _query_name(ss, i)
            if not results:
                fp.write(f"{qname}\t0\tno_match\t-1\t-1\t0\n")
            else:
                for r, res in enumerate(results):
                    fp.write(f"{qname}\t{r + 1}\t{res['genome_name']}\t"
                             f"{res['distance']:.6f}\t{res['cluster_id']}\t"
                             f"{res['cluster_size']}\n")


# Source: rabbittclust_tpu/cli/repdb.py::write_assign_tsv
def write_assign_tsv(state, ss, output_file: str, precomputed=None) -> None:
    assigned = unassigned = 0
    with open(output_file, "w") as fp:
        fp.write("#query\tassigned_cluster\trep_name\tdistance\t"
                 "cluster_size\tstatus\n")
        for i in range(len(ss)):
            res = precomputed[i] if precomputed is not None \
                else state.assign(ss.hashes[i])
            qname = _query_name(ss, i)
            if res["rep_idx"] >= 0:
                fp.write(f"{qname}\t{res['cluster_id']}\t"
                         f"{res['genome_name']}\t{res['distance']:.6f}\t"
                         f"{res['cluster_size']}\tassigned\n")
                assigned += 1
            else:
                fp.write(f"{qname}\t-1\tunassigned\t-1\t0\tnovel\n")
                unassigned += 1
    print(f"  Assigned: {assigned}  Novel: {unassigned}", file=sys.stderr)


# Source: rabbittclust_tpu/cli/repdb.py::_build_state_from_sketchset
def _build_state_from_sketchset(ss, p, threshold: float) -> KssdClusterState:
    from ..cluster.greedy import greedy_cluster
    order = ss.kssd_greedy_order()
    ss2 = ss.reorder(order)
    gres = greedy_cluster(ss2.hashes, threshold, p.kmer_size, presorted=True)
    return KssdClusterState.from_clustering(ss2, p, gres, threshold), ss2


# Source: rabbittclust_tpu/cli/repdb.py::run_greedy_repdb
def run_greedy_repdb(args, opts, device=None) -> int:
    """KSSD (--fast) and MinHash greedy RepDB verbs."""
    if not args.is_fast:
        if getattr(args, "multihost", None):
            # without this guard every launched process would run the full
            # serial MinHash query/assign and race on the same output file
            print("ERROR: --multihost RepDB serving requires --fast (the "
                  "MinHash RepDB verbs are single-host)", file=sys.stderr)
            return 1
        return run_mh_repdb(args, opts)
    db = args.repdb_path
    if getattr(args, "multihost", None) and not (args.repdb_query
                                                 or args.repdb_assign):
        print("ERROR: --multihost supports the --query/--assign RepDB "
              "verbs only (build/append/stats are single-host)",
              file=sys.stderr)
        return 1
    if args.repdb_stats:
        st = KssdClusterState.load_repdb(db)
        st.print_stats(sys.stdout)
        return 0
    if args.repdb_build:
        threshold = args.threshold
        if args.presketched:
            from ..state.sketch_io import load_kssd_sketches
            ss, p = load_kssd_sketches(args.presketched)
        elif args.input:
            kmer = args.kmer_size or 19
            if args.sketch_by_file:
                ss, p = sketch_files_kssd(read_file_list(args.input),
                                          args.min_len, kmer, args.drlevel,
                                          args.threads)
            else:
                ss, p = sketch_sequences_kssd(args.input, args.min_len, kmer,
                                              args.drlevel, args.threads)
        else:
            print("ERROR: --build requires --presketched <folder> or -i "
                  "<genome_list> -l", file=sys.stderr)
            return 1
        state, ss2 = _build_state_from_sketchset(ss, p, threshold)
        state.save_repdb(db)
        if args.output:
            from ..state.cluster_io import write_cluster_file
            write_cluster_file(args.output, state.clusters, ss2, threshold)
        return 0
    if args.repdb_query or args.repdb_assign:
        if getattr(args, "multihost", None) and not args.input:
            print("ERROR: --query/--assign requires -i <input_file>",
                  file=sys.stderr)
            return 1
        if getattr(args, "multihost", None):
            from ..workflows_dist import (parse_multihost_spec,
                                          repdb_query_multihost)
            coord, n_proc, pid = parse_multihost_spec(args.multihost)
            repdb_query_multihost(
                db, args.input, args.output, coord, n_proc, pid,
                sketch_by_file=args.sketch_by_file, topk=args.topk,
                assign=bool(args.repdb_assign), min_len=args.min_len,
                threads=args.threads,
                devices=None if device is None else [device])
            return 0
    if args.repdb_query:
        if not args.input:
            print("ERROR: --query requires -i <input_file>", file=sys.stderr)
            return 1
        state = KssdClusterState.load_repdb(db)
        ss = _sketch_queries(args, state.kmer_size, state.params.drlevel)
        from ..state.greedy_state import batch_query_device
        results = batch_query_device(state, ss.hashes, args.topk,
                                     device=resolve_device(device))
        write_query_tsv(state, ss, args.output, args.topk,
                        precomputed=results)
        return 0
    if args.repdb_assign:
        if not args.input:
            print("ERROR: --assign requires -i <input_file>", file=sys.stderr)
            return 1
        state = KssdClusterState.load_repdb(db)
        ss = _sketch_queries(args, state.kmer_size, state.params.drlevel)
        write_assign_tsv(state, ss, args.output)
        return 0
    if args.append:
        state = KssdClusterState.load_repdb(db)
        args.input = args.append
        ss = _sketch_queries(args, state.kmer_size, state.params.drlevel)
        state.incremental_cluster(ss)
        state.save_repdb(db)
        if args.output:
            state.write_cluster_result(args.output)
        return 0
    print("ERROR: --db requires one of: --build, --query, --assign, "
          "--append, --stats", file=sys.stderr)
    return 1


# Source: rabbittclust_tpu/cli/repdb.py::_sketch_mst_queries
def _sketch_mst_queries(args, st):
    """Sketch query genomes with the parameters stored in an MST state."""
    if st.kind == "kssd":
        return _sketch_queries(args, st.kmer_size, st.drlevel)
    from ..sketch.minhash import MinHashParams
    from ..sketch.minhash import sketch_files_minhash, sketch_sequences_minhash
    p = MinHashParams(kmer_size=st.kmer_size, sketch_size=st.sketch_size,
                      is_containment=st.is_containment,
                      contain_compress=st.contain_compress)
    if args.sketch_by_file:
        return sketch_files_minhash(read_file_list(args.input), args.min_len,
                                    p, args.threads)
    return sketch_sequences_minhash(args.input, args.min_len, p, args.threads)


# Source: rabbittclust_tpu/cli/repdb.py::run_mst_repdb
def run_mst_repdb(args, opts, device=None) -> int:
    """MST RepDB verbs over the tree-medoid state (mst_state); --fast
    selects the KSSD flavor, otherwise MinHash (reference mst_repdb_* /
    mst_repdb_*_fast).  ``--build`` takes the dense engine."""
    from ..state.mst_state import MstState
    db = args.repdb_path
    if args.repdb_stats:
        st = MstState.load(db)
        st.print_stats(sys.stdout)
        return 0
    if args.repdb_build:
        from ..cluster.mst import cut_forest, clusters_from_forest
        from ..workflows import _compute_mst_engine
        if args.is_fast:
            if args.presketched:
                from ..state.sketch_io import load_kssd_sketches
                ss, p = load_kssd_sketches(args.presketched)
            elif args.input:
                kmer = args.kmer_size or 21
                if args.sketch_by_file:
                    ss, p = sketch_files_kssd(read_file_list(args.input),
                                              args.min_len, kmer,
                                              args.drlevel, args.threads)
                else:
                    ss, p = sketch_sequences_kssd(args.input, args.min_len,
                                                  kmer, args.drlevel,
                                                  args.threads)
            else:
                print("ERROR: --build requires --presketched <folder> or -i "
                      "<genome_list> -l", file=sys.stderr)
                return 1
            kmer_size = p.kmer_size
            state_params = dict(kind="kssd", kmer_size=p.kmer_size,
                                half_k=p.half_k, half_subk=p.half_subk,
                                drlevel=p.drlevel)
        else:
            from ..sketch.minhash import MinHashParams
            if args.presketched:
                from ..state.sketch_io import load_minhash_sketches
                ss, p = load_minhash_sketches(args.presketched)
            elif args.input:
                p = MinHashParams(
                    kmer_size=args.kmer_size or 21,
                    sketch_size=args.sketch_size or 1000,
                    is_containment=args.contain_compress is not None,
                    contain_compress=args.contain_compress or 0)
                from ..sketch.minhash import (
                    sketch_files_minhash, sketch_sequences_minhash)
                if args.sketch_by_file:
                    ss = sketch_files_minhash(read_file_list(args.input),
                                              args.min_len, p, args.threads)
                else:
                    ss = sketch_sequences_minhash(args.input, args.min_len,
                                                  p, args.threads)
            else:
                print("ERROR: --build requires --presketched <folder> or -i "
                      "<genome_list> -l", file=sys.stderr)
                return 1
            kmer_size = p.kmer_size
            state_params = dict(kind="minhash", kmer_size=p.kmer_size,
                                sketch_size=p.sketch_size,
                                contain_compress=p.contain_compress,
                                is_containment=p.is_containment)
        res = _compute_mst_engine(ss, args.threshold, kmer_size,
                                  args.contain_compress is not None, opts,
                                  resolve_device(device))
        forest = cut_forest(res.mst, args.threshold)
        clusters = clusters_from_forest(forest, len(ss))
        kind = state_params.pop("kind")
        st = MstState.from_clustering(ss, kind, forest, clusters,
                                      args.threshold, **state_params)
        st.save(db)
        if args.output:
            from ..state.cluster_io import write_cluster_file
            write_cluster_file(args.output, clusters, ss, args.threshold)
        return 0
    if args.repdb_query or args.repdb_assign:
        if not args.input:
            print("ERROR: --query/--assign requires -i <input_file>",
                  file=sys.stderr)
            return 1
        st = MstState.load(db)
        ss = _sketch_mst_queries(args, st)
        if args.repdb_query:
            write_query_tsv(st, ss, args.output, args.topk)
        else:
            write_assign_tsv(st, ss, args.output)
        return 0
    if args.append:
        st = MstState.load(db)
        args.input = args.append
        ss = _sketch_mst_queries(args, st)
        live = st.append_cluster(ss)
        st.save(db)
        if args.output:
            st.write_cluster_result(live, args.output, st.threshold)
        return 0
    print("ERROR: --db requires one of: --build, --query, --assign, "
          "--append, --stats", file=sys.stderr)
    return 1


# ---------------------------------------------------------------------------
# MinHash RepDB verbs (reference mh_repdb_*, sub_command.cpp:478-700)
# ---------------------------------------------------------------------------

# Source: rabbittclust_tpu/cli/repdb.py::_sketch_queries_minhash
def _sketch_queries_minhash(args, p):
    from ..sketch.minhash import sketch_files_minhash, sketch_sequences_minhash
    if args.sketch_by_file:
        files = read_file_list(args.input)
        return sketch_files_minhash(files, args.min_len, p, args.threads)
    return sketch_sequences_minhash(args.input, args.min_len, p, args.threads)


# Source: rabbittclust_tpu/cli/repdb.py::run_mh_repdb
def run_mh_repdb(args, opts) -> int:
    from ..sketch.minhash import MinHashParams
    from ..state.greedy_state import MinHashClusterState
    db = args.repdb_path
    if args.repdb_stats:
        st = MinHashClusterState.load_repdb(db)
        st.print_stats(sys.stdout)
        return 0
    if args.repdb_build:
        threshold = args.threshold
        if args.presketched:
            from ..state.sketch_io import load_minhash_sketches
            ss, p = load_minhash_sketches(args.presketched)
        elif args.input:
            p = MinHashParams(
                kmer_size=args.kmer_size or 21,
                sketch_size=args.sketch_size or 1000,
                is_containment=args.contain_compress is not None,
                contain_compress=args.contain_compress or 0)
            ss = _sketch_queries_minhash(args, p)
        else:
            print("ERROR: --build requires --presketched <folder> or -i "
                  "<genome_list> -l", file=sys.stderr)
            return 1
        from ..cluster.greedy import greedy_cluster
        order = ss.sort_by_size_desc()
        ss2 = ss.reorder(order)
        gres = greedy_cluster(ss2.hashes, threshold, p.kmer_size,
                              presorted=True,
                              is_containment=p.is_containment)
        state = MinHashClusterState.from_clustering(ss2, p, gres, threshold)
        state.save_repdb(db)
        if args.output:
            from ..state.cluster_io import write_cluster_file
            write_cluster_file(args.output, state.clusters, ss2, threshold)
        return 0
    if args.repdb_query or args.repdb_assign:
        if not args.input:
            print("ERROR: --query/--assign requires -i <input_file>",
                  file=sys.stderr)
            return 1
        st = MinHashClusterState.load_repdb(db)
        p = MinHashParams(kmer_size=st.kmer_size,
                          sketch_size=st.sketch_size,
                          is_containment=st.is_containment,
                          contain_compress=st.contain_compress)
        ss = _sketch_queries_minhash(args, p)
        if args.repdb_query:
            write_query_tsv(st, ss, args.output, args.topk)
        else:
            write_assign_tsv(st, ss, args.output)
        return 0
    if args.append:
        st = MinHashClusterState.load_repdb(db)
        p = MinHashParams(kmer_size=st.kmer_size,
                          sketch_size=st.sketch_size,
                          is_containment=st.is_containment,
                          contain_compress=st.contain_compress)
        args.input = args.append
        ss = _sketch_queries_minhash(args, p)
        st.incremental_cluster(ss)
        st.save_repdb(db)
        if args.output:
            st.write_cluster_result(args.output)
        return 0
    print("ERROR: --db requires one of: --build, --query, --assign, "
          "--append, --stats", file=sys.stderr)
    return 1
