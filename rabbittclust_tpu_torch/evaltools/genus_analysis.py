"""Genus/species cluster-relationship analysis (reference
benchmark/analysis/analyze_genus_pair_clusters.py,
analyze_genus_species_relationships.py, plot_genus_pair_visualization.py).

Offline post-hoc tools over a `.cluster` output + NCBI ground-truth TSVs:

  * ``pair``          — distribution of two genera across the clusters that
    contain them (per-cluster counts/ratios, merge typing, summary TSVs);
  * ``relationships`` — full mixed-cluster audit: purity, majority labels,
    suspects, genus co-occurrence, boundary-conflict vs minority-outlier
    classification (top_genus_pairs / boundary_conflicts /
    minority_outliers / suspects / cluster_summary TSVs);
  * ``plot``          — the four-panel PNG of a pair distribution table.

Output file names and TSV columns match the reference scripts so existing
downstream tooling keeps working.  Accession extraction uses the same
``GC[AF]_\\d+\\.\\d+`` search-anywhere-in-line rule as the reference's
analysis scripts (NOT the stricter calLabel basename rule in
evaltools/evaluate.py — the scripts differ upstream too).

The port's copy of ``rabbittclust_tpu/evaltools/genus_analysis.py``.
"""

from __future__ import annotations

import argparse
import csv
import re
import sys
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

# Source: rabbittclust_tpu/evaltools/genus_analysis.py::_RE_CLUSTER
_RE_CLUSTER = re.compile(r"^the cluster\s+(\d+)\s+is:", re.I)
# Source: rabbittclust_tpu/evaltools/genus_analysis.py::_RE_ACC
_RE_ACC = re.compile(r"(GC[AF]_\d+\.\d+)")


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::parse_cluster_accessions
def parse_cluster_accessions(cluster_file: str) -> List[Tuple[str, int]]:
    """[(accession, cluster_id), ...] in file order (reference
    parse_cluster_file of the analysis scripts; a repeated accession's
    LAST occurrence wins in the dict views below, like the originals)."""
    out: List[Tuple[str, int]] = []
    cur = None
    with open(cluster_file, errors="ignore") as fp:
        for line in fp:
            s = line.strip()
            m = _RE_CLUSTER.match(s)
            if m:
                cur = int(m.group(1))
                continue
            if cur is None or not s:
                continue
            ma = _RE_ACC.search(line)
            if ma:
                out.append((ma.group(1), cur))
    return out


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::_read_groundtruth_tsv
def _read_groundtruth_tsv(path: str, id_col: str,
                          name_words: int) -> Tuple[Dict[str, int],
                                                    Dict[int, str],
                                                    Dict[str, str]]:
    """(acc -> id, id -> display name, acc -> organism name) from a TSV
    with columns assembly_accession / <id_col> / organism_name.  The
    display name is the first ``name_words`` words of organism_name with
    underscores treated as spaces (genus = 1 word, species = 2)."""
    acc_to_id: Dict[str, int] = {}
    id_to_name: Dict[int, str] = {}
    acc_to_org: Dict[str, str] = {}
    with open(path, errors="ignore") as fp:
        for row in csv.DictReader(fp, delimiter="\t"):
            acc = (row.get("assembly_accession") or "").strip()
            raw = (row.get(id_col) or "").strip()
            org = (row.get("organism_name") or "").strip()
            if not acc or not raw:
                continue
            try:
                tid = int(raw)
            except ValueError:
                continue
            acc_to_id[acc] = tid
            acc_to_org[acc] = org
            if org:
                parts = org.replace("_", " ").split()
                if parts:
                    id_to_name.setdefault(
                        tid, " ".join(parts[:name_words])
                        if len(parts) >= name_words else parts[0])
    return acc_to_id, id_to_name, acc_to_org


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::analyze_pair_distribution
def analyze_pair_distribution(acc_to_cluster: Dict[str, int],
                              acc_to_genus: Dict[str, int],
                              genus_names: Dict[int, str],
                              g1: int, g2: int) -> List[dict]:
    """Per-cluster composition rows for every cluster containing genus g1
    or g2 (reference analyze_cluster_distribution): counts/ratios for g1,
    g2 and 'other', unique-accession tallies, merge typing (Balanced merge
    when both ratios >= 0.3, else Minority merge)."""
    target = {cid for acc, cid in acc_to_cluster.items()
              if acc_to_genus.get(acc) in (g1, g2)}
    members = defaultdict(list)
    for acc, cid in acc_to_cluster.items():
        if cid in target:
            members[cid].append(acc)
    rows = []
    for cid, accs in members.items():
        c1 = sum(1 for a in accs if acc_to_genus.get(a) == g1)
        c2 = sum(1 for a in accs if acc_to_genus.get(a) == g2)
        other = len(accs) - c1 - c2
        total = len(accs)
        if not total:
            continue
        mixed = c1 > 0 and c2 > 0
        if mixed:
            kind = ("Balanced merge" if c1 / total >= 0.3
                    and c2 / total >= 0.3 else "Minority merge")
        elif c1:
            kind = f"{genus_names.get(g1, 'G1')} only"
        elif c2:
            kind = f"{genus_names.get(g2, 'G2')} only"
        else:
            kind = "Other only"
        rows.append({
            "cluster_id": cid, "total_genomes": total,
            "g1_count": c1, "g2_count": c2, "other_count": other,
            "g1_ratio": c1 / total, "g2_ratio": c2 / total,
            "other_ratio": other / total,
            # upstream counts unique accessions per bucket ("species_nuniq"
            # despite the name — replicated for column parity)
            "g1_species_nuniq": c1, "g2_species_nuniq": c2,
            "other_species_nuniq": other, "total_species_nuniq": total,
            "is_mixed": mixed, "merge_type": kind,
        })
    rows.sort(key=lambda r: r["cluster_id"])
    return rows


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::main_pair
def main_pair(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Analyze cluster distribution for a genus pair")
    ap.add_argument("--cluster-file", required=True)
    ap.add_argument("--genus-groundtruth", required=True)
    ap.add_argument("--g1-id", type=int, required=True)
    ap.add_argument("--g2-id", type=int, required=True)
    ap.add_argument("--g1-name", required=True)
    ap.add_argument("--g2-name", required=True)
    ap.add_argument("--output-dir", required=True)
    args = ap.parse_args(argv)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    acc_to_cluster = dict(parse_cluster_accessions(args.cluster_file))
    acc_to_genus, genus_names, _ = _read_groundtruth_tsv(
        args.genus_groundtruth, "genus_id", 1)
    rows = analyze_pair_distribution(acc_to_cluster, acc_to_genus,
                                     genus_names, args.g1_id, args.g2_id)

    n1, n2 = args.g1_name.lower(), args.g2_name.lower()
    cols = ["cluster_id", "total_genomes", f"{n1}_count", f"{n2}_count",
            "other_count", f"{n1}_ratio", f"{n2}_ratio", "other_ratio",
            f"{n1}_species_nuniq", f"{n2}_species_nuniq",
            "other_species_nuniq", "total_species_nuniq", "is_mixed",
            "merge_type"]
    table = out_dir / f"{n1}_{n2}_cluster_distribution.tsv"
    with open(table, "w", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=cols, delimiter="\t")
        w.writeheader()
        for r in rows:
            w.writerow({
                "cluster_id": r["cluster_id"],
                "total_genomes": r["total_genomes"],
                f"{n1}_count": r["g1_count"], f"{n2}_count": r["g2_count"],
                "other_count": r["other_count"],
                f"{n1}_ratio": f"{r['g1_ratio']:.3f}",
                f"{n2}_ratio": f"{r['g2_ratio']:.3f}",
                "other_ratio": f"{r['other_ratio']:.3f}",
                f"{n1}_species_nuniq": r["g1_species_nuniq"],
                f"{n2}_species_nuniq": r["g2_species_nuniq"],
                "other_species_nuniq": r["other_species_nuniq"],
                "total_species_nuniq": r["total_species_nuniq"],
                "is_mixed": str(r["is_mixed"]),
                "merge_type": r["merge_type"],
            })

    merged = [r for r in rows if r["is_mixed"]]
    only1 = [r for r in rows if r["g1_count"] and not r["g2_count"]]
    only2 = [r for r in rows if r["g2_count"] and not r["g1_count"]]
    t1 = sum(r["g1_count"] for r in rows)
    t2 = sum(r["g2_count"] for r in rows)
    tg = sum(r["total_genomes"] for r in rows)
    summary = out_dir / f"{n1}_{n2}_cluster_distribution_summary.tsv"
    with open(summary, "w", newline="") as fp:
        w = csv.writer(fp, delimiter="\t")
        w.writerow(["metric", "value"])
        w.writerow([f"Total clusters with {args.g1_name} or "
                    f"{args.g2_name}", len(rows)])
        w.writerow(["Clusters with both genera (merged)", len(merged)])
        w.writerow([f"Clusters with {args.g1_name} only", len(only1)])
        w.writerow([f"Clusters with {args.g2_name} only", len(only2)])
        w.writerow([f"Total {args.g1_name} genomes", t1])
        w.writerow([f"Total {args.g2_name} genomes", t2])
        w.writerow(["Total genomes in relevant clusters", tg])
        w.writerow([f"{args.g1_name} ratio (overall)",
                    f"{t1 / tg if tg else 0:.3f}"])
        w.writerow([f"{args.g2_name} ratio (overall)",
                    f"{t2 / tg if tg else 0:.3f}"])
    print(f"Detailed results written to: {table}")
    print(f"Summary written to: {summary}")
    return 0


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::analyze_cluster_relationships
def analyze_cluster_relationships(acc_cluster: List[Tuple[str, int]],
                                  acc_to_species: Dict[str, int],
                                  acc_to_org: Dict[str, str],
                                  acc_to_genus: Dict[str, int]) -> Dict:
    """Cluster-level purity/majority/suspect analysis (reference
    analyze_clusters): only accessions WITH species ground truth count;
    a member is a suspect when its genus or species differs from the
    cluster's majority."""
    members = defaultdict(list)
    for acc, cid in acc_cluster:
        if acc in acc_to_species:
            members[cid].append(acc)
    stats: Dict[int, dict] = {}
    for cid, accs in members.items():
        g_counts: Counter = Counter()
        s_counts: Counter = Counter()
        for acc in accs:
            sp = acc_to_species.get(acc)
            if not sp:
                continue
            s_counts[sp] += 1
            g = acc_to_genus.get(acc)
            if g:
                g_counts[g] += 1
        size = len(accs)
        mg = g_counts.most_common(1)[0][0] if g_counts else None
        ms = s_counts.most_common(1)[0][0] if s_counts else None
        suspects = []
        for acc in accs:
            sp = acc_to_species.get(acc)
            if not sp:
                continue
            g = acc_to_genus.get(acc)
            if (mg and g != mg) or (ms and sp != ms):
                suspects.append({
                    "accession": acc, "genus_id": g, "species_taxid": sp,
                    "organism_name": acc_to_org.get(acc, ""),
                    "cluster_id": cid})
        stats[cid] = {
            "cluster_id": cid, "cluster_size": size,
            "genus_nuniq": len(g_counts), "species_nuniq": len(s_counts),
            "genus_counts": dict(g_counts),
            "species_counts": dict(s_counts),
            "majority_genus": mg, "majority_species": ms,
            "genus_purity": g_counts[mg] / size if mg else 0.0,
            "species_purity": s_counts[ms] / size if ms else 0.0,
            "is_mixed_genus": len(g_counts) > 1,
            "is_mixed_species": len(s_counts) > 1,
            "suspects": suspects,
        }
    return stats


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::genus_cooccurrence
def genus_cooccurrence(stats: Dict[int, dict]) -> Dict[Tuple[int, int],
                                                       List[dict]]:
    """{(g1, g2) sorted: [per-cluster info]} over mixed-genus clusters."""
    co = defaultdict(list)
    for cid, st in stats.items():
        if not st["is_mixed_genus"]:
            continue
        gl = list(st["genus_counts"])
        for i, a in enumerate(gl):
            for b in gl[i + 1:]:
                pair = tuple(sorted((a, b)))
                co[pair].append({
                    "cluster_id": cid, "cluster_size": st["cluster_size"],
                    "g1_count": st["genus_counts"][a],
                    "g2_count": st["genus_counts"][b],
                    "g1_ratio": st["genus_counts"][a] / st["cluster_size"],
                    "g2_ratio": st["genus_counts"][b] / st["cluster_size"],
                    "species_nuniq": st["species_nuniq"],
                    "genus_nuniq": st["genus_nuniq"],
                    "genus_purity": st["genus_purity"],
                    "species_purity": st["species_purity"]})
    return co


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::classify_cooccurrence
def classify_cooccurrence(co: Dict[Tuple[int, int], List[dict]],
                          threshold_balanced: float = 0.3,
                          threshold_clean: float = 0.7) -> Dict[str, list]:
    """boundary_conflict (both genera substantial, impure, size >= 10) vs
    minority_outlier (>= 0.7 dominant, < 0.3 minority)."""
    out = {"boundary_conflict": [], "minority_outlier": []}
    for (g1, g2), infos in co.items():
        for info in infos:
            lo = min(info["g1_ratio"], info["g2_ratio"])
            hi = max(info["g1_ratio"], info["g2_ratio"])
            if (lo >= threshold_balanced
                    and info["genus_purity"] < threshold_clean
                    and info["cluster_size"] >= 10):
                out["boundary_conflict"].append(
                    {"g1": g1, "g2": g2, **info})
            elif hi >= 0.7 and lo < 0.3:
                out["minority_outlier"].append({"g1": g1, "g2": g2, **info})
    return out


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::main_relationships
def main_relationships(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Analyze genus/species relationships in clusters")
    ap.add_argument("--cluster", required=True)
    ap.add_argument("--species-groundtruth", required=True)
    ap.add_argument("--genus-groundtruth", required=True)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--output-dir", default=".")
    args = ap.parse_args(argv)

    acc_cluster = parse_cluster_accessions(args.cluster)
    acc_to_species, species_names, acc_to_org = _read_groundtruth_tsv(
        args.species_groundtruth, "species_taxid", 2)
    acc_to_genus, genus_names, _ = _read_groundtruth_tsv(
        args.genus_groundtruth, "genus_id", 1)
    stats = analyze_cluster_relationships(acc_cluster, acc_to_species,
                                          acc_to_org, acc_to_genus)
    co = genus_cooccurrence(stats)
    top = sorted(co.items(), key=lambda kv: len(kv[1]),
                 reverse=True)[:args.top_k]
    classified = classify_cooccurrence(co)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def gname(g):
        return genus_names.get(g, f"genus_{g}")

    def sname(s):
        return species_names.get(s, f"species_{s}")

    with open(out_dir / "top_genus_pairs.tsv", "w", newline="") as fp:
        w = csv.writer(fp, delimiter="\t")
        w.writerow(["g1", "g1_name", "g2", "g2_name", "cluster_id",
                    "cluster_size", "g1_count", "g2_count", "g1_ratio",
                    "g2_ratio", "species_nuniq", "score"])
        for (g1, g2), infos in top:
            for c in infos:
                w.writerow([g1, gname(g1), g2, gname(g2), c["cluster_id"],
                            c["cluster_size"], c["g1_count"], c["g2_count"],
                            f"{c['g1_ratio']:.3f}", f"{c['g2_ratio']:.3f}",
                            c["species_nuniq"],
                            min(c["g1_count"], c["g2_count"])])

    with open(out_dir / "boundary_conflicts.tsv", "w", newline="") as fp:
        w = csv.writer(fp, delimiter="\t")
        w.writerow(["g1", "g1_name", "g2", "g2_name", "cluster_id",
                    "cluster_size", "g1_count", "g2_count", "g1_ratio",
                    "g2_ratio", "species_nuniq", "genus_purity"])
        for it in classified["boundary_conflict"]:
            w.writerow([it["g1"], gname(it["g1"]), it["g2"],
                        gname(it["g2"]), it["cluster_id"],
                        it["cluster_size"], it["g1_count"], it["g2_count"],
                        f"{it['g1_ratio']:.3f}", f"{it['g2_ratio']:.3f}",
                        it["species_nuniq"], f"{it['genus_purity']:.3f}"])

    with open(out_dir / "minority_outliers.tsv", "w", newline="") as fp:
        w = csv.writer(fp, delimiter="\t")
        w.writerow(["g1", "g1_name", "g2", "g2_name", "cluster_id",
                    "cluster_size", "g1_count", "g2_count", "g1_ratio",
                    "g2_ratio", "species_nuniq"])
        for it in classified["minority_outlier"]:
            w.writerow([it["g1"], gname(it["g1"]), it["g2"],
                        gname(it["g2"]), it["cluster_id"],
                        it["cluster_size"], it["g1_count"], it["g2_count"],
                        f"{it['g1_ratio']:.3f}", f"{it['g2_ratio']:.3f}",
                        it["species_nuniq"]])

    suspects = [s for st in stats.values() for s in st["suspects"]]
    with open(out_dir / "suspects.tsv", "w", newline="") as fp:
        w = csv.writer(fp, delimiter="\t")
        w.writerow(["accession", "cluster_id", "genus_id", "genus_name",
                    "species_taxid", "species_name", "organism_name"])
        for s in suspects:
            w.writerow([s["accession"], s["cluster_id"], s["genus_id"],
                        gname(s["genus_id"]) if s["genus_id"] else "Unknown",
                        s["species_taxid"],
                        sname(s["species_taxid"])
                        if s["species_taxid"] else "Unknown",
                        s["organism_name"]])

    with open(out_dir / "cluster_summary.tsv", "w", newline="") as fp:
        w = csv.writer(fp, delimiter="\t")
        w.writerow(["cluster_id", "cluster_size", "genus_nuniq",
                    "species_nuniq", "majority_genus", "majority_genus_name",
                    "majority_species", "majority_species_name",
                    "genus_purity", "species_purity", "is_mixed_genus",
                    "is_mixed_species", "n_suspects"])
        for st in sorted(stats.values(), key=lambda x: x["cluster_id"]):
            w.writerow([
                st["cluster_id"], st["cluster_size"], st["genus_nuniq"],
                st["species_nuniq"], st["majority_genus"],
                gname(st["majority_genus"])
                if st["majority_genus"] else "Unknown",
                st["majority_species"],
                sname(st["majority_species"])
                if st["majority_species"] else "Unknown",
                f"{st['genus_purity']:.3f}", f"{st['species_purity']:.3f}",
                st["is_mixed_genus"], st["is_mixed_species"],
                len(st["suspects"])])

    print(f"Results written to {out_dir}/")
    print(f"  - top_genus_pairs.tsv: Top-{args.top_k} genus pairs")
    print(f"  - boundary_conflicts.tsv: "
          f"{len(classified['boundary_conflict'])} boundary conflict cases")
    print(f"  - minority_outliers.tsv: "
          f"{len(classified['minority_outlier'])} minority outlier cases")
    print(f"  - suspects.tsv: {len(suspects)} suspect genomes")
    print("  - cluster_summary.tsv: Summary of all clusters")
    return 0


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::main_plot
def main_plot(argv=None) -> int:
    """Four-panel PNG of a pair-distribution table (reference
    plot_genus_pair_visualization.py layout: stacked merged-cluster bars,
    overall pie, size histogram, summary text)."""
    ap = argparse.ArgumentParser(
        description="Visualize genus pair relationship")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--g1-name", required=True)
    ap.add_argument("--g2-name", required=True)
    args = ap.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    with open(args.input) as fp:
        clusters = list(csv.DictReader(fp, delimiter="\t"))
    c1 = f"{args.g1_name.lower()}_count"
    c2 = f"{args.g2_name.lower()}_count"
    merged = [c for c in clusters if c.get("is_mixed", "").lower() == "true"]
    only1 = [c for c in clusters if c.get("is_mixed", "").lower() == "false"
             and int(c.get(c1, 0)) > 0]
    only2 = [c for c in clusters if c.get("is_mixed", "").lower() == "false"
             and int(c.get(c2, 0)) > 0]

    fig = plt.figure(figsize=(14, 10))
    gs = fig.add_gridspec(2, 2, hspace=0.3, wspace=0.3)

    ax = fig.add_subplot(gs[0, 0])
    if merged:
        ms = sorted(merged, key=lambda c: int(c.get("total_genomes", 0)),
                    reverse=True)
        ids = [c["cluster_id"] for c in ms]
        v1 = [int(c.get(c1, 0)) for c in ms]
        v2 = [int(c.get(c2, 0)) for c in ms]
        x = np.arange(len(ids))
        ax.bar(x, v1, 0.6, label=args.g1_name, color="#3498db",
               edgecolor="black", linewidth=0.5)
        ax.bar(x, v2, 0.6, bottom=v1, label=args.g2_name, color="#9b59b6",
               edgecolor="black", linewidth=0.5)
        for i, (a, b) in enumerate(zip(v1, v2)):
            if a:
                ax.text(i, a / 2, str(a), ha="center", va="center",
                        fontsize=8, fontweight="bold", color="white")
            if b:
                ax.text(i, a + b / 2, str(b), ha="center", va="center",
                        fontsize=8, fontweight="bold", color="white")
            ax.text(i, a + b + 0.5, f"n={a + b}", ha="center", va="bottom",
                    fontsize=7)
        ax.set_xticks(x)
        ax.set_xticklabels(ids, rotation=45, ha="right")
        ax.legend(loc="upper right", fontsize=9)
        ax.grid(axis="y", alpha=0.3)
    else:
        ax.text(0.5, 0.5, "No merged clusters found", ha="center",
                va="center", transform=ax.transAxes, fontsize=12)
    ax.set_xlabel("Cluster ID", fontsize=11, fontweight="bold")
    ax.set_ylabel("Number of Genomes", fontsize=11, fontweight="bold")
    ax.set_title("Merged Clusters: Composition Breakdown", fontsize=12,
                 fontweight="bold")

    ax = fig.add_subplot(gs[0, 1])
    t1 = sum(int(c.get(c1, 0)) for c in clusters)
    t2 = sum(int(c.get(c2, 0)) for c in clusters)
    to = sum(int(c.get("other_count", 0)) for c in clusters)
    if t1 + t2 + to > 0:
        ax.pie([t1, t2, to], labels=[args.g1_name, args.g2_name, "Other"],
               colors=["#3498db", "#9b59b6", "#95a5a6"], autopct="%1.1f%%",
               explode=(0.05, 0.1, 0), shadow=True, startangle=90,
               textprops={"fontsize": 10, "fontweight": "bold"})
    else:
        ax.text(0.5, 0.5, "No data", ha="center", va="center",
                transform=ax.transAxes, fontsize=12)
    ax.set_title("Overall Genome Distribution\nin Relevant Clusters",
                 fontsize=12, fontweight="bold")

    ax = fig.add_subplot(gs[1, 0])
    sizes = [[int(c.get("total_genomes", 0)) for c in grp]
             for grp in (merged, only1, only2)]
    flat = [v for grp in sizes for v in grp]
    if flat:
        bins = np.arange(0, max(flat) + 5, 5)
        ax.hist(sizes, bins=bins,
                label=["Merged", f"{args.g1_name} only",
                       f"{args.g2_name} only"],
                color=["#e74c3c", "#3498db", "#9b59b6"], alpha=0.7,
                edgecolor="black", linewidth=0.5)
        ax.legend(loc="upper right", fontsize=9)
    else:
        ax.text(0.5, 0.5, "No data", ha="center", va="center",
                transform=ax.transAxes, fontsize=12)
    ax.set_xlabel("Cluster Size (number of genomes)", fontsize=11,
                  fontweight="bold")
    ax.set_ylabel("Number of Clusters", fontsize=11, fontweight="bold")
    ax.set_title("Cluster Size Distribution", fontsize=12,
                 fontweight="bold")
    ax.grid(axis="y", alpha=0.3)

    ax = fig.add_subplot(gs[1, 1])
    ax.axis("off")
    n_tot = len(clusters)
    n_m = len(merged)
    g_m = sum(int(c.get("total_genomes", 0)) for c in merged)
    bal = [c for c in merged if c.get("merge_type", "") == "Balanced merge"]
    t1m = sum(int(c.get(c1, 0)) for c in merged)
    t2m = sum(int(c.get(c2, 0)) for c in merged)
    big = max(bal, key=lambda c: int(c.get("total_genomes", 0)),
              default=None)

    def pct(a, b):
        return f"{a / b * 100:.1f}%" if b else "0%"

    text = (
        "\n    SUMMARY STATISTICS\n\n"
        f"    Total Clusters: {n_tot}\n"
        f"    |- Merged Clusters: {n_m} ({pct(n_m, n_tot)})\n"
        f"    |  |- Balanced Merges: {len(bal)}\n"
        f"    |  `- Minority Merges: {n_m - len(bal)}\n"
        f"    |- {args.g1_name} Only: {len(only1)}\n"
        f"    `- {args.g2_name} Only: {len(only2)}\n\n"
        f"    Total Genomes in Merged Clusters: {g_m}\n"
        f"    |- {args.g1_name}: {t1m} ({pct(t1m, g_m)})\n"
        f"    `- {args.g2_name}: {t2m} ({pct(t2m, g_m)})\n\n"
        "    Key Finding:\n"
        f"    Largest balanced merge: Cluster "
        f"{big['cluster_id'] if big else 'N/A'}\n"
        f"    ({big.get('total_genomes', '0') if big else 0} genomes)\n")
    ax.text(0.1, 0.9, text, transform=ax.transAxes, fontsize=10,
            verticalalignment="top", family="monospace",
            bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.3))

    plt.suptitle(f"{args.g1_name} and {args.g2_name} Relationship Analysis",
                 fontsize=16, fontweight="bold", y=0.995)
    plt.savefig(args.output, dpi=200, bbox_inches="tight",
                facecolor="white")
    print(f"Visualization saved to: {args.output}")
    return 0


# Source: rabbittclust_tpu/evaltools/genus_analysis.py::main
def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("pair", "relationships", "plot"):
        print("usage: python -m "
              "rabbittclust_tpu_torch.evaltools.genus_analysis "
              "{pair,relationships,plot} [options]", file=sys.stderr)
        return 2
    return {"pair": main_pair, "relationships": main_relationships,
            "plot": main_plot}[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
