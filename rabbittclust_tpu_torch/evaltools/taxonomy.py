"""Taxonomy-analysis long tail of the evaluation harness.

Functional equivalents of the reference's offline benchmark tools
(benchmark/evaluation/src/):

  * precal_label          — precalLabel.cpp: conflict-resolved cluster
    labeling for F1/NMI preprocessing (each ground-truth taxid labels at
    most ONE cluster; defeated clusters fall back to their next-most-common
    taxid or a fresh negative "bad" label);
  * cal_purity            — calPurity.cpp: per-cluster purity table plus the
    ``.accession.unpurity`` / ``.accession.purity`` cluster files that feed
    the taxonomy walk;
  * analysis_purity       — analysisPurity.cpp: walk nodes.dmp lineages for
    every accession of the impure clusters and split clusters into
    same-genus / diff-genus / genus-missing reports;
  * check_taxonomy_status — checkTaxonomyStatus.cpp: join the analysis
    output with NCBI's ANI_report_prokaryotes.txt and count best-match /
    excluded-from-refseq statuses;
  * map_genome            — mapGenome.cpp: verify all sequences of each
    genome file share one nomenclature type (first two comment tokens).

Where the reference iterates unordered_maps (tie order unspecified), we
sort deterministically by (-count, label); all other orders and the output
file formats are replicated, including the reference's ``no_rank`` column
quirk: lineages insert the rank string "no rank" (with a space) but the
reports look up "no_rank", so that column is always 0
(analysisPurity.cpp:118,215-225).

The port's copy of ``rabbittclust_tpu/evaltools/taxonomy.py``.
"""

from __future__ import annotations

import os
import sys
from collections import Counter
from typing import Dict, List, Tuple


# ---------------------------------------------------------------------------
# shared parsing helpers


# Source: rabbittclust_tpu/evaltools/taxonomy.py::accession_from_filename
def accession_from_filename(file_name: str) -> str:
    """Replicates the reference's substring dance (calPurity.cpp:303-307):
    basename up to the first '_' after position 5 ("GCF_xxx" keeps the
    'GCF_' prefix), falling back to the first '.' after position 5."""
    start = file_name.rfind("/")
    end = file_name.find("_", start + 5)
    if end == -1:
        end = file_name.find(".", start + 5)
    if end == -1:
        end = len(file_name)
    return file_name[start + 1:end]


# Source: rabbittclust_tpu/evaltools/taxonomy.py::read_ground_truth_3col
def read_ground_truth_3col(path: str) -> Tuple[Dict[str, int], Dict[int, str],
                                               Dict[str, int]]:
    """``<assembly_accession species_taxid genomeName>`` per line, header
    skipped (groundTruth.cpp; precalLabel.cpp:126-138).  Returns
    (accession->taxid, taxid->organism, genomeName->taxid)."""
    by_file: Dict[str, int] = {}
    organism: Dict[int, str] = {}
    by_seq: Dict[str, int] = {}
    with open(path) as f:
        f.readline()  # header
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            acc, taxid, name = parts[0], int(parts[1]), parts[2]
            by_file.setdefault(acc, taxid)
            # the reference joins ALL remaining tokens and keeps a trailing
            # space (groundTruth.cpp:44-47 discards the trimming substr)
            organism.setdefault(taxid, " ".join(parts[2:]) + " ")
            by_seq.setdefault(name, taxid)
    return by_file, organism, by_seq


# Source: rabbittclust_tpu/evaltools/taxonomy.py::_cluster_label_rows
def _cluster_label_rows(clust_file: str, by_file: bool):
    """Yield (is_header, accession_key) rows of a RabbitTClust .cluster
    file: header rows start a new cluster; member rows carry the accession
    (fileName substring in -l mode, sequence name in -i mode)."""
    with open(clust_file) as f:
        for line in f:
            if not line.strip("\n"):
                continue
            if not line.startswith("\t"):
                yield True, None
                continue
            cols = line.rstrip("\n").split("\t")
            # '', idx, gid, len, fileName, seqName, ... (-l)
            # '', idx, gid, len, seqName, ...           (-i)
            if by_file:
                key = accession_from_filename(cols[4].strip())
            else:
                key = cols[4].strip()
            yield False, key


# ---------------------------------------------------------------------------
# precalLabel


# Source: rabbittclust_tpu/evaltools/taxonomy.py::resolve_cluster_labels
def resolve_cluster_labels(cluster_counts: List[List[Tuple[int, int]]]
                           ) -> List[int]:
    """updateLabel (precalLabel.cpp:66-106): assign each cluster its
    most-common ground-truth taxid, but a taxid may label only ONE cluster —
    the one holding more of it.  A defeated cluster re-tries its remaining
    taxids (in count-descending order) and, if all are taken by stronger
    clusters, receives a fresh negative label (-1, -2, ...).

    ``cluster_counts[c]`` = [(taxid, count), ...] sorted count-descending.
    Implemented iteratively (the reference recurses on each defeat)."""
    n = len(cluster_counts)
    remaining = [list(c) for c in cluster_counts]
    global_map: Dict[int, Tuple[int, int]] = {}  # taxid -> (cluster, count)
    labels = [0] * n
    bad = -1
    for start in range(n):
        stack = [start]
        while stack:
            cid = stack.pop()
            assigned = False
            while remaining[cid] and not assigned:
                lab, num = remaining[cid][0]
                if lab not in global_map:
                    global_map[lab] = (cid, num)
                    labels[cid] = lab
                    assigned = True
                else:
                    prev_cid, prev_num = global_map[lab]
                    if num > prev_num:
                        labels[cid] = lab
                        global_map[lab] = (cid, num)
                        assigned = True
                        stack.append(prev_cid)  # defeated: re-label
                remaining[cid].pop(0)
            if not assigned:
                labels[cid] = bad
                bad -= 1
    return labels


# Source: rabbittclust_tpu/evaltools/taxonomy.py::precal_label
def precal_label(argument: str, ground_truth: str, input_file: str,
                 output_file: str) -> Tuple[List[int], List[int]]:
    """precalLabel.cpp RabbitTClust path: emit ``output_file`` with two
    space-separated rows (resolved cluster labels repeated per member, then
    per-genome ground-truth labels) and ``.humanReadable`` with one
    ``our\\tstandard`` pair per genome."""
    by_file_map, _, by_seq_map = read_ground_truth_3col(ground_truth)
    truth = by_file_map if argument == "-l" else by_seq_map

    clusters: List[List[int]] = []
    cur: List[int] = []
    started = False
    for is_header, key in _cluster_label_rows(input_file,
                                              argument == "-l"):
        if is_header:
            if started and cur:
                clusters.append(cur)
            cur = []
            started = True
            continue
        if key in truth:
            cur.append(truth[key])
    if started and cur:
        clusters.append(cur)

    counts = [sorted(Counter(c).items(), key=lambda kv: (-kv[1], kv[0]))
              for c in clusters]
    labels = resolve_cluster_labels(counts)

    ours: List[int] = []
    std: List[int] = []
    for lab, members in zip(labels, clusters):
        for t in members:
            ours.append(lab)
            std.append(t)
    with open(output_file + ".humanReadable", "w") as f1:
        for a, b in zip(ours, std):
            f1.write(f"{a}\t{b}\n")
    with open(output_file, "w") as f:
        f.write(" ".join(map(str, ours)) + " \n")
        f.write(" ".join(map(str, std)) + " \n")
    return ours, std


# ---------------------------------------------------------------------------
# calPurity


# Source: rabbittclust_tpu/evaltools/taxonomy.py::cal_purity
def cal_purity(argument: str, ground_truth: str, clust_file: str,
               output_file: str) -> Dict[str, float]:
    """calPurity.cpp: write the purity table (size-descending) and the
    ``.accession.unpurity`` / ``.accession.purity`` cluster files consumed
    by analysis_purity.  Returns the summary metrics it logs."""
    by_file_map, organism, by_seq_map = read_ground_truth_3col(ground_truth)
    truth = by_file_map if argument == "-l" else by_seq_map

    clusters: List[List[Tuple[str, int]]] = []  # [(accession, taxid)]
    cur: List[Tuple[str, int]] = []
    started = False
    for is_header, key in _cluster_label_rows(clust_file, argument == "-l"):
        if is_header:
            if started and cur:
                clusters.append(cur)
            cur = []
            started = True
            continue
        if key in truth:
            cur.append((key, truth[key]))
    if started and cur:
        clusters.append(cur)

    rows = []           # (total, dominant, taxid)
    species_groups = []  # per cluster: [[(acc, taxid)...] size-desc]
    for members in clusters:
        cnt = Counter(t for _, t in members)
        dom_taxid, dom = max(cnt.items(), key=lambda kv: (kv[1], -kv[0]))
        rows.append((len(members), dom, dom_taxid))
        groups: Dict[int, List[Tuple[str, int]]] = {}
        for acc, t in members:
            groups.setdefault(t, []).append((acc, t))
        species_groups.append(sorted(groups.values(),
                                     key=lambda g: (-len(g), g[0][1])))

    total = sum(r[0] for r in rows)
    dominant = sum(r[1] for r in rows)
    covered = sum(r[0] for r in rows if r[0] > 1)
    with open(output_file, "w") as f:
        f.write("Purity\ttotalNumber\tdominateNumber\tdominateSpeciesId"
                "\tdominateOriganism\n")
        for tot, dom, taxid in sorted(rows, key=lambda r: -r[0]):
            f.write("%8f\t%8d\t%8d\t\t%8d\t%s\n"
                    % (dom / tot, tot, dom, taxid, organism.get(taxid, "")))

    with open(output_file + ".accession.unpurity", "w") as f:
        for groups in species_groups:
            if len(groups) > 1:
                acc, t = groups[0][0]
                f.write(f"{acc}\t{t}\n")
                for g in groups[1:]:
                    for acc, t in g:
                        f.write(f"\t{acc}\t{t}\n")
                f.write("\n")
    with open(output_file + ".accession.purity", "w") as f:
        for groups in species_groups:
            if len(groups) == 1:
                acc, t = groups[0][0]
                f.write(f"{acc}\t{t}\n")
    return {"purity": dominant / total if total else 0.0,
            "coverage": covered / total if total else 0.0,
            "clusters": len(rows)}


# ---------------------------------------------------------------------------
# analysisPurity


# Source: rabbittclust_tpu/evaltools/taxonomy.py::load_nodes_dmp
def load_nodes_dmp(path: str) -> Dict[int, Tuple[int, str]]:
    """nodes.dmp -> taxid -> (parent taxid, rank).  Fields are
    tab-pipe-delimited; delimiter runs are compressed like the reference's
    boost::split(..., is_any_of("\\t|"), token_compress_on)."""
    import re
    nodes: Dict[int, Tuple[int, str]] = {}
    with open(path) as f:
        for line in f:
            parts = [p for p in re.split(r"[\t|]+", line) if p != ""]
            if len(parts) < 3:
                continue
            nodes[int(parts[0])] = (int(parts[1]), parts[2])
    return nodes


# Source: rabbittclust_tpu/evaltools/taxonomy.py::lineage_ranks
def lineage_ranks(nodes: Dict[int, Tuple[int, str]], taxid: int
                  ) -> Dict[str, int]:
    """Walk rootward from ``taxid`` recording the LAST node seen per rank
    (analysisPurity.cpp:204-253: every ancestor overwrites its rank slot,
    so higher nodes win; the node itself is recorded first)."""
    out: Dict[str, int] = {}
    if taxid in nodes:
        out[nodes[taxid][1]] = taxid
    cur = taxid
    while cur in nodes and cur != 1:
        cur = nodes[cur][0]
        if cur not in nodes:
            break
        out[nodes[cur][1]] = cur
    return out


# Source: rabbittclust_tpu/evaltools/taxonomy.py::_RANK_COLS
_RANK_COLS = ("species", "no_rank", "genus", "family", "order")


# Source: rabbittclust_tpu/evaltools/taxonomy.py::analysis_purity
def analysis_purity(nodes_file: str, input_file: str, output_file: str,
                    level: str = "genus") -> Dict[str, int]:
    """analysisPurity.cpp: for each impure cluster from cal_purity's
    ``.accession.unpurity``, compare the rep's ``level`` taxid against every
    minority member's and write ``.same`` (all share the rep's genus),
    ``.diff`` (split across both, mismatching members to .diff and matching
    ones to .same/.same0), ``.same0`` (rep has no genus).  Clusters flush
    on BLANK lines only, like the reference (no trailing flush)."""
    nodes = load_nodes_dmp(nodes_file)
    header = "label\taccession\tspecies\tno_rank\tgenus\tfamily\torder\n"
    outs = {ext: open(output_file + ext, "w")
            for ext in (".same", ".diff", ".same0")}
    for o in outs.values():
        o.write(header)

    def fmt(tag: str, acc: str, cls: Dict[str, int]) -> str:
        cols = "\t".join(str(cls.get(r, 0)) for r in _RANK_COLS)
        return f"{tag}\t{acc}\t{cols}\n"

    stats = {"same": 0, "diff": 0, "same0": 0, "not_in_taxonomy": 0}
    reps: List[Tuple[str, Dict[str, int]]] = []
    bads: List[Tuple[str, Dict[str, int]]] = []

    def flush():
        if not reps and not bads:
            return
        rep_cls = reps[0][1] if reps else {}
        rep_level = rep_cls.get(level, 0)
        if all(b[1].get(level, 0) == rep_level for b in bads):
            dst = ".same" if rep_level != 0 else ".same0"
            stats["same" if rep_level != 0 else "same0"] += 1
            for acc, cls in reps:
                outs[dst].write(fmt("+", acc, cls))
            for acc, cls in bads:
                outs[dst].write(fmt("-", acc, cls))
            outs[dst].write("\n")
        else:
            stats["diff"] += 1
            for acc, cls in reps:
                outs[".diff"].write(fmt("+", acc, cls))
            eq = [b for b in bads if b[1].get(level, 0) == rep_level]
            dst = ".same" if rep_level != 0 else ".same0"
            if eq:
                for acc, cls in reps:
                    outs[dst].write(fmt("+", acc, cls))
            for acc, cls in bads:
                if cls.get(level, 0) != rep_level:
                    outs[".diff"].write(fmt("-", acc, cls))
                else:
                    outs[dst].write(fmt("-", acc, cls))
            if eq:
                outs[dst].write("\n")
            outs[".diff"].write("\n")

    with open(input_file) as f:
        for line in f:
            if not line.strip("\n"):
                flush()
                reps, bads = [], []
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            acc, taxid = parts[0], int(parts[1])
            if taxid not in nodes:
                stats["not_in_taxonomy"] += 1
                continue
            cls = lineage_ranks(nodes, taxid)
            if not line.startswith("\t"):
                reps.append((acc, cls))
            else:
                bads.append((acc, cls))
    for o in outs.values():
        o.close()
    return stats


# ---------------------------------------------------------------------------
# checkTaxonomyStatus


# Source: rabbittclust_tpu/evaltools/taxonomy.py::_MATCH_STATUSES
_MATCH_STATUSES = (
    "species-match", "subspecies-match", "synonym-match",
    "derived-species-match", "genus-match", "approved-mismatch", "mismatch",
    "below-threshold-match", "below-threshold-mismatch", "low-coverage")


# Source: rabbittclust_tpu/evaltools/taxonomy.py::check_taxonomy_status
def check_taxonomy_status(ani_file: str, ana_file: str, output_file: str
                          ) -> Dict[str, Dict[str, int]]:
    """checkTaxonomyStatus.cpp: join the analysis_purity output with NCBI's
    ANI_report_prokaryotes.txt (<accession, species-taxid,
    best-match-taxid, status, excluded-from-refseq, qcov, scov>) and write
    the six ``.check`` reports + match-status counters for rep (+) and
    minority (-) genomes."""
    ani: Dict[str, Tuple[int, int, str, str, float, float]] = {}
    with open(ani_file) as f:
        f.readline()
        for line in f:
            v = [p for p in line.rstrip("\n").split("\t") if p != ""]
            if len(v) < 7:
                continue
            ani[v[0]] = (
                int(v[1]) if v[1] != "na" else 0,
                int(v[2]) if v[2] != "na" else 0,
                v[3], v[4],
                float(v[5]) if v[5] != "na" else 0.0,
                float(v[6]) if v[6] != "na" else 0.0)

    exts = (".species_taxid.check", ".best_match_species_taxid.check",
            ".exclude_from_refseq.check", ".best_match_status.check",
            ".perfect.check", ".coverage.check")
    heads = ("label\taccession\tassembly_taxid\ttaxonomy_taxid",
             "label\taccession\tassembly_taxid\tbest_match_species_taxid",
             "label\taccession\texclude_from_refseq",
             "label\taccession\tbest_match_status",
             "label\taccession\tassembly_taxid",
             "label\taccession\tqcoverage\tscoverage")
    outs = [open(output_file + e, "w") for e in exts]
    for o, h in zip(outs, heads):
        o.write(h + "\n")

    stats = {"+": dict.fromkeys(_MATCH_STATUSES, 0),
             "-": dict.fromkeys(_MATCH_STATUSES, 0)}
    totals = {"+": Counter(), "-": Counter()}
    not_in_taxonomy = 0
    with open(ana_file) as f:
        f.readline()  # header
        for line in f:
            if not line.strip("\n"):
                for i in (0, 1, 2, 3, 5):
                    outs[i].write("\n")
                continue
            parts = line.split()
            if len(parts) < 3:
                continue
            tag, acc, species = parts[0], parts[1], int(parts[2])
            if acc not in ani:
                not_in_taxonomy += 1
                continue
            sid, bmid, status, efr, qcov, scov = ani[acc]
            t = totals[tag]
            t["total"] += 1
            if species != sid:
                t["taxid_mismatch"] += 1
            if sid != bmid:
                t["best_match_mismatch"] += 1
            if efr != "na":
                t["excluded_from_refseq"] += 1
            if status != "species-match":
                t["not_species_match"] += 1
            if status in stats[tag]:
                stats[tag][status] += 1
            perfect = (species == sid and sid == bmid and efr == "na"
                       and status == "species-match") if tag == "+" else (
                       species == bmid and efr == "na")
            if perfect:
                t["perfect"] += 1
                outs[4].write(line if line.endswith("\n") else line + "\n")
            outs[0].write(f"{tag}\t{acc}\t{species}\t{sid}\n")
            outs[1].write(f"{tag}\t{acc}\t{species}\t{bmid}\n")
            outs[2].write(f"{tag}\t{acc}\t{efr}\n")
            outs[3].write(f"{tag}\t{acc}\t{status}\n")
            outs[5].write(f"{tag}\t{acc}\t{qcov:g}\t{scov:g}\n")
    for o in outs:
        o.close()
    return {"match_status": stats, "not_in_taxonomy": not_in_taxonomy,
            "rep": dict(totals["+"]), "bad": dict(totals["-"])}


# ---------------------------------------------------------------------------
# mapGenome


# Source: rabbittclust_tpu/evaltools/taxonomy.py::map_genome
def map_genome(list_file: str, output_file: str = "mapType.out"
               ) -> List[str]:
    """mapGenome.cpp: per genome file, count the distinct nomenclature
    types (first two comment tokens; a leading 'UNVERIFIED*' token is
    dropped; trailing commas stripped).  Returns files holding >1 type."""
    from ..io.fasta import read_fasta
    bad: List[str] = []
    with open(list_file) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    with open(output_file, "w") as out:
        for path in files:
            counts: Counter = Counter()
            for _, comment, _ in read_fasta(path):
                toks = (comment or "").split()
                toks += [""] * (3 - len(toks))
                t0, t1, t2 = toks[0], toks[1], toks[2]
                if t0[:10] == "UNVERIFIED":
                    t0, t1 = t1, t2
                if t0.endswith(","):
                    t0 = t0[:-1]
                if t1.endswith(","):
                    t1 = t1[:-1]
                counts[f"{t0}\t{t1}"] += 1
            if len(counts) != 1:
                bad.append(path)
            for key, n in sorted(counts.items()):
                out.write(f"{key}\t{n}\n")
            out.write("\n")
    return bad


# ---------------------------------------------------------------------------
# CLI


# Source: rabbittclust_tpu/evaltools/taxonomy.py::main
def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m rabbittclust_tpu_torch.evaltools.taxonomy",
        description="Taxonomy analysis tools (precalLabel / calPurity / "
                    "analysisPurity / checkTaxonomyStatus / mapGenome)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _mode_parser(name):
        p = sub.add_parser(name)
        g = p.add_mutually_exclusive_group(required=True)
        g.add_argument("-l", dest="argument", action="store_const",
                       const="-l", help="genomes served as files")
        g.add_argument("-i", dest="argument", action="store_const",
                       const="-i", help="genomes served as sequences")
        p.add_argument("ground_truth")
        p.add_argument("cluster_file")
        p.add_argument("output")

    _mode_parser("precal-label")
    _mode_parser("cal-purity")

    p = sub.add_parser("analysis-purity")
    p.add_argument("nodes_dmp")
    p.add_argument("purity_accession")
    p.add_argument("output")
    p.add_argument("--level", default="genus",
                   choices=["species", "genus", "family"])

    p = sub.add_parser("check-status")
    p.add_argument("ani_report")
    p.add_argument("analysis_file")
    p.add_argument("output")

    p = sub.add_parser("map-genome")
    p.add_argument("list_file")
    p.add_argument("-o", "--output", default="mapType.out")

    args = ap.parse_args(argv)
    if args.cmd == "precal-label":
        ours, std = precal_label(args.argument, args.ground_truth,
                                 args.cluster_file, args.output)
        print(f"labeled genomes: {len(ours)}")
    elif args.cmd == "cal-purity":
        m = cal_purity(args.argument, args.ground_truth, args.cluster_file,
                       args.output)
        print(f"the coverage is: {m['coverage']:g}")
        print(f"the final purity is: {m['purity']:g}")
    elif args.cmd == "analysis-purity":
        s = analysis_purity(args.nodes_dmp, args.purity_accession,
                            args.output, level=args.level)
        print(f"same={s['same']} diff={s['diff']} same0={s['same0']} "
              f"not_in_taxonomy={s['not_in_taxonomy']}")
    elif args.cmd == "check-status":
        r = check_taxonomy_status(args.ani_report, args.analysis_file,
                                  args.output)
        print(f"rep total={r['rep'].get('total', 0)} "
              f"perfect={r['rep'].get('perfect', 0)}; "
              f"bad total={r['bad'].get('total', 0)} "
              f"perfect={r['bad'].get('perfect', 0)}")
    elif args.cmd == "map-genome":
        bad = map_genome(args.list_file, args.output)
        print(f"files with >1 nomenclature type: {len(bad)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
