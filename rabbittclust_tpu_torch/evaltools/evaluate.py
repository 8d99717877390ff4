"""Clustering evaluation harness (reference benchmark/evaluation).

Re-derivation of the offline tools:
  * parse_cluster_file  — reads a RabbitTClust `.cluster` file into
    per-cluster accession lists (calLabel.cpp semantics: accession = first
    token of the fileName basename in -l mode, of the sequence name in -i
    mode);
  * ground truth file  — `<accession, taxid, organismName>` per line, first
    line a header;
  * label matrix       — 2 x N (prediction taxid vs ground-truth taxid),
    prediction = dominant taxid of the cluster (calLabel);
  * NMI / weighted F1  — sklearn metrics (getNMI.py);
  * purity / coverage  — per-cluster dominant fraction (calPurity);
  * representative list — first genome per cluster (getRepresentativeList).

The port's copy of ``rabbittclust_tpu/evaltools/evaluate.py``.
"""

from __future__ import annotations

import os
import re
import sys
from collections import Counter
from typing import Dict, List, Tuple


# Source: rabbittclust_tpu/evaltools/evaluate.py::accession_of
def accession_of(name: str) -> str:
    """GCF_000123.1_... -> GCF_000123.1 ; otherwise the basename with FASTA
    extensions stripped (first whitespace token)."""
    base = os.path.basename(name)
    m = re.match(r"^(GC[AF]_\d+\.\d+)", base)
    if m:
        return m.group(1)
    base = re.split(r"\s", base)[0]
    for ext in (".gz", ".fna", ".fa", ".fasta"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    return base


# Source: rabbittclust_tpu/evaltools/evaluate.py::parse_cluster_file
def parse_cluster_file(path: str, by_file: bool) -> List[List[str]]:
    """Cluster file -> list of accession lists (cluster order preserved)."""
    clusters: List[List[str]] = []
    cur: List[str] = None
    with open(path) as f:
        for line in f:
            if line.startswith("the cluster"):
                if cur is not None:
                    clusters.append(cur)
                cur = []
            elif line.startswith("\t") and cur is not None:
                cols = line.rstrip("\n").split("\t")
                # by-file row: '', idx, gid, len, fileName, seqName, comment
                # by-seq row:  '', idx, gid, len, seqName, comment
                name = cols[4].strip() if len(cols) > 4 else ""
                cur.append(accession_of(name))
    if cur is not None:
        clusters.append(cur)
    return clusters


# Source: rabbittclust_tpu/evaltools/evaluate.py::read_ground_truth
def read_ground_truth(path: str) -> Dict[str, str]:
    """accession -> taxid, skipping the header line."""
    out: Dict[str, str] = {}
    with open(path) as f:
        first = True
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                parts = line.split()
            if first:
                first = False
                # skip header if non-numeric taxid column
                if len(parts) >= 2 and not parts[1].strip().isdigit():
                    continue
            if len(parts) >= 2:
                out[parts[0].strip()] = parts[1].strip()
    return out


# Source: rabbittclust_tpu/evaltools/evaluate.py::label_matrix
def label_matrix(clusters: List[List[str]], truth: Dict[str, str]
                 ) -> Tuple[List[str], List[str]]:
    """(prediction labels, ground-truth labels) for all genomes found in the
    ground truth; each cluster predicts its dominant taxid (calLabel)."""
    pred, gt = [], []
    for members in clusters:
        taxids = [truth[a] for a in members if a in truth]
        if not taxids:
            continue
        dominant = Counter(taxids).most_common(1)[0][0]
        for t in taxids:
            pred.append(dominant)
            gt.append(t)
    return pred, gt


# Source: rabbittclust_tpu/evaltools/evaluate.py::nmi_score
def nmi_score(pred: List[str], gt: List[str]) -> float:
    from sklearn import metrics
    return float(metrics.normalized_mutual_info_score(pred, gt))


# Source: rabbittclust_tpu/evaltools/evaluate.py::weighted_f1
def weighted_f1(pred: List[str], gt: List[str]) -> float:
    from sklearn import metrics
    return float(metrics.f1_score(gt, pred, average="weighted",
                                  zero_division=0))


# Source: rabbittclust_tpu/evaltools/evaluate.py::purity_report
def purity_report(clusters: List[List[str]], truth: Dict[str, str]
                  ) -> Dict[str, float]:
    """Total purity = dominant-taxid fraction over all labeled genomes;
    coverage = labeled fraction (calPurity semantics)."""
    total = 0
    pure = 0
    labeled = 0
    per_cluster = []
    for members in clusters:
        taxids = [truth[a] for a in members if a in truth]
        total += len(members)
        labeled += len(taxids)
        if not taxids:
            per_cluster.append(0.0)
            continue
        dom = Counter(taxids).most_common(1)[0][1]
        pure += dom
        per_cluster.append(dom / len(taxids))
    return {
        "purity": pure / labeled if labeled else 0.0,
        "coverage": labeled / total if total else 0.0,
        "per_cluster": per_cluster,
    }


# Source: rabbittclust_tpu/evaltools/evaluate.py::representative_list
def representative_list(clusters: List[List[str]]) -> List[str]:
    return [c[0] for c in clusters if c]


# Source: rabbittclust_tpu/evaltools/evaluate.py::main
def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Evaluate a .cluster file against taxonomy ground truth "
                    "(NMI, weighted F1, purity/coverage)")
    ap.add_argument("ground_truth")
    ap.add_argument("cluster_file")
    ap.add_argument("-l", dest="by_file", action="store_true",
                    help="cluster file was produced in by-file (-l) mode")
    args = ap.parse_args(argv)
    truth = read_ground_truth(args.ground_truth)
    clusters = parse_cluster_file(args.cluster_file, args.by_file)
    pred, gt = label_matrix(clusters, truth)
    print(f"genomes labeled: {len(pred)}")
    print(f"NMI:  {nmi_score(pred, gt):.6f}")
    print(f"F1w:  {weighted_f1(pred, gt):.6f}")
    rep = purity_report(clusters, truth)
    print(f"purity:   {rep['purity']:.6f}")
    print(f"coverage: {rep['coverage']:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
