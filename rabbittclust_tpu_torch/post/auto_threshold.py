"""Automatic threshold selection + stability analysis.

Faithful re-derivation of the reference subsystem (src/MST.cpp:1743-2375):
  * analyzeEdgeLengthDistribution — quartiles/σ over MST edge lengths with
    near-zero (<=1e-10) edges filtered;
  * findThresholdCandidates — largest gaps in sorted edge lengths
    (gap > range*min_gap_ratio), plus quartile fallbacks, each labeled with
    a heuristic taxonomic level;
  * computeThresholdStability — edge-flip rate under +-epsilon threshold
    perturbation with adaptive window, split/merge sensitivities;
  * selectOptimalThreshold — confidence scoring with 2x boost in the
    0.01-0.1 band and gap bonus;
  * printThresholdAnalysis — <output>.threshold_analysis.txt report.

Note: like the reference, auto-threshold only *reports*; clustering still
uses the user-specified threshold (sub_command.cpp:1853-1897).
"""

from __future__ import annotations

import sys
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..cluster.mst import clusters_from_forest, cut_forest


# Source: rabbittclust_tpu/post/auto_threshold.py::EdgeLengthStats
@dataclass
class EdgeLengthStats:
    min_dist: float = 0.0
    max_dist: float = 0.0
    median_dist: float = 0.0
    mean_dist: float = 0.0
    q1_dist: float = 0.0
    q3_dist: float = 0.0
    std_dev: float = 0.0
    sorted_distances: List[float] = field(default_factory=list)


# Source: rabbittclust_tpu/post/auto_threshold.py::StabilityResult
@dataclass
class StabilityResult:
    overall: float = 0.5
    split: float = 0.5
    merge: float = 0.5
    near_edge_count: int = 0


# Source: rabbittclust_tpu/post/auto_threshold.py::ThresholdCandidate
@dataclass
class ThresholdCandidate:
    threshold: float = 0.05
    gap_score: float = 0.0
    edge_index: int = -1
    confidence: float = 0.0
    level: str = "unknown"
    stability_score: float = 0.5
    stability_split: float = 0.5
    stability_merge: float = 0.5
    near_edge_count: int = 0
    cluster_count: int = 0


# Source: rabbittclust_tpu/post/auto_threshold.py::analyze_edge_length_distribution
def analyze_edge_length_distribution(mst) -> EdgeLengthStats:
    stats = EdgeLengthStats()
    d = np.asarray(mst[2], dtype=np.float64)
    d = np.sort(d[d > 1e-10])
    stats.sorted_distances = d.tolist()
    n = len(d)
    if n == 0:
        return stats
    stats.min_dist = float(d[0])
    stats.max_dist = float(d[-1])
    if n == 1:
        stats.median_dist = stats.mean_dist = float(d[0])
        stats.q1_dist = stats.q3_dist = float(d[0])
        return stats
    stats.median_dist = float((d[n // 2 - 1] + d[n // 2]) / 2.0 if n % 2 == 0
                              else d[n // 2])
    stats.q1_dist = float(d[max(0, n // 4)])
    stats.q3_dist = float(d[min(n - 1, (3 * n) // 4)])
    stats.mean_dist = float(d.mean())
    stats.std_dev = float(np.sqrt(((d - d.mean()) ** 2).sum() / n))
    return stats


# Source: rabbittclust_tpu/post/auto_threshold.py::compute_threshold_stability
def compute_threshold_stability(mst, threshold: float, num_vertices: int,
                                epsilon: float = 0.01, num_samples: int = 5,
                                min_near_edges: int = 100) -> StabilityResult:
    result = StabilityResult()
    dists = np.asarray(mst[2], dtype=np.float64)
    if num_vertices <= 0 or len(dists) == 0:
        return result
    # exact replication of the reference's adaptive window loop
    # (MST.cpp:1845-1873): collect only while cur_eps <= threshold/2; the
    # final near-set corresponds to the last epsilon tried inside the loop.
    max_epsilon = threshold * 0.5
    cur_eps = epsilon
    lo = max(0.0, threshold - cur_eps)
    hi = threshold + cur_eps
    near = np.empty(0, dtype=np.float64)
    while len(near) < min_near_edges and cur_eps <= max_epsilon:
        lo = max(0.0, threshold - cur_eps)
        hi = threshold + cur_eps
        near = np.sort(dists[(dists >= lo) & (dists <= hi)])
        if len(near) < min_near_edges:
            cur_eps *= 1.5
    result.near_edge_count = int(len(near))
    if len(near) == 0:
        result.overall = result.split = result.merge = 1.0
        return result
    near_list = near.tolist()
    step = (hi - lo) / (num_samples - 1) if num_samples > 1 else 0.0
    tot = tot_s = tot_m = 0.0
    n_valid = n_s = n_m = 0
    for s in range(num_samples):
        t = lo + s * step
        if t < 0.0:
            continue
        if abs(t - threshold) < 1e-10:
            # reference MST.cpp:1904-1915: the "t' == threshold" sample
            # contributes consistency 1.0, and is STILL classified as a
            # split/merge sample by the inexact floating comparison
            # (lo + 2*step usually lands one ulp below the threshold)
            tot += 1.0
            n_valid += 1
            if t < threshold:
                tot_s += 1.0
                n_s += 1
            elif t > threshold:
                tot_m += 1.0
                n_m += 1
            continue
        flip_lo, flip_hi = min(threshold, t), max(threshold, t)
        flips = bisect_right(near_list, flip_hi) - bisect_right(near_list, flip_lo)
        consistency = (len(near_list) - flips) / len(near_list)
        tot += consistency
        n_valid += 1
        if t < threshold:
            tot_s += consistency
            n_s += 1
        else:
            tot_m += consistency
            n_m += 1
    if n_valid:
        result.overall = tot / n_valid
    if n_s:
        result.split = tot_s / n_s
    if n_m:
        result.merge = tot_m / n_m
    result.overall = min(result.split, result.merge)
    return result


_LEVELS = [(0.001, "identical/near-identical"), (0.005, "strain/subspecies"),
           (0.01, "strain"), (0.03, "species"), (0.1, "genus"),
           (0.2, "family")]


# Source: rabbittclust_tpu/post/auto_threshold.py::_level
def _level(th: float, coarse: bool = False) -> str:
    if coarse:  # range-zero fallback path uses the 4-level ladder
        if th < 0.01:
            return "strain"
        if th < 0.03:
            return "species"
        if th < 0.1:
            return "genus"
        return "higher"
    for cut, name in _LEVELS:
        if th < cut:
            return name
    return "higher"


# Source: rabbittclust_tpu/post/auto_threshold.py::_fill_cluster_stats
def _fill_cluster_stats(cand: ThresholdCandidate, mst, num_vertices: int,
                        enable_stability: bool):
    if num_vertices <= 0:
        return
    if enable_stability:
        st = compute_threshold_stability(mst, cand.threshold, num_vertices)
        cand.stability_score = st.overall
        cand.stability_split = st.split
        cand.stability_merge = st.merge
        cand.near_edge_count = st.near_edge_count
    clusters = clusters_from_forest(cut_forest(mst, cand.threshold),
                                    num_vertices)
    cand.cluster_count = len(clusters)


# Source: rabbittclust_tpu/post/auto_threshold.py::find_threshold_candidates
def find_threshold_candidates(mst, max_candidates: int = 5,
                              min_gap_ratio: float = 0.05,
                              enable_stability: bool = False,
                              num_vertices: int = 0
                              ) -> List[ThresholdCandidate]:
    candidates: List[ThresholdCandidate] = []
    if len(mst[0]) < 2:
        return candidates
    stats = analyze_edge_length_distribution(mst)
    d = stats.sorted_distances
    n = len(d)
    rng = stats.max_dist - stats.min_dist
    if rng <= 1e-10:
        cand = ThresholdCandidate(threshold=stats.median_dist, confidence=0.5,
                                  level=_level(stats.median_dist, coarse=True))
        _fill_cluster_stats(cand, mst, num_vertices, enable_stability)
        candidates.append(cand)
        return candidates
    min_gap = rng * min_gap_ratio
    gaps = [(d[i] - d[i - 1], i) for i in range(1, n) if d[i] - d[i - 1] > min_gap]
    gaps.sort(key=lambda x: -x[0])
    for gap, idx in gaps[:max_candidates]:
        cand = ThresholdCandidate(
            threshold=d[idx], gap_score=gap, edge_index=idx,
            confidence=min(1.0, gap / rng * 10.0), level=_level(d[idx]))
        _fill_cluster_stats(cand, mst, num_vertices, enable_stability)
        candidates.append(cand)
    percentiles = []
    if stats.q1_dist >= 0.001:
        percentiles.append(stats.q1_dist)
    percentiles += [stats.median_dist, stats.q3_dist]
    for th in percentiles:
        if th < 0.001:
            continue
        if any(abs(c.threshold - th) < min_gap * 0.5 for c in candidates):
            continue
        if not (stats.min_dist < th < stats.max_dist):
            continue
        cand = ThresholdCandidate(threshold=th, confidence=0.4,
                                  level=_level(th))
        _fill_cluster_stats(cand, mst, num_vertices, enable_stability)
        candidates.append(cand)
    candidates.sort(key=lambda c: c.threshold)
    return candidates


# Source: rabbittclust_tpu/post/auto_threshold.py::select_optimal_threshold
def select_optimal_threshold(candidates: List[ThresholdCandidate],
                             mst) -> ThresholdCandidate:
    if not candidates:
        return ThresholdCandidate(threshold=0.05, confidence=0.0,
                                  level="unknown")
    best_score = -1.0
    optimal = None
    found_reasonable = False
    for cand in candidates:
        if cand.threshold < 0.001:
            continue
        score = cand.confidence
        if 0.01 <= cand.threshold <= 0.1:
            score *= 2.0
            found_reasonable = True
        elif 0.001 <= cand.threshold < 0.01:
            score *= 1.2
        elif 0.1 < cand.threshold <= 0.2:
            score *= 1.1
        if cand.gap_score > 0.0:
            score += cand.gap_score * 20.0
        if score > best_score:
            best_score = score
            optimal = cand
    if not found_reasonable and best_score < 0:
        stats = analyze_edge_length_distribution(mst)
        med = stats.median_dist
        if 0.01 <= med <= 0.2:
            lvl = "species" if med < 0.03 else ("genus" if med < 0.1 else "family")
            return ThresholdCandidate(threshold=med, confidence=0.4, level=lvl)
        return ThresholdCandidate(threshold=0.05, confidence=0.3, level="genus")
    return optimal if optimal is not None else candidates[0]


# Source: rabbittclust_tpu/post/auto_threshold.py::print_threshold_analysis
def print_threshold_analysis(mst, stats: EdgeLengthStats,
                             candidates: List[ThresholdCandidate],
                             optimal: ThresholdCandidate,
                             output_file: str) -> None:
    with open(output_file, "w") as fp:
        fp.write("# Automatic Threshold Selection Analysis\n")
        fp.write("# Based on MST Edge Length Distribution\n")
        fp.write("# ===========================================\n\n")
        fp.write("## Edge Length Statistics\n")
        fp.write(f"Total edges: {len(mst[0])}\n")
        fp.write(f"Min distance: {stats.min_dist:.6f}\n")
        fp.write(f"Max distance: {stats.max_dist:.6f}\n")
        fp.write(f"Mean distance: {stats.mean_dist:.6f}\n")
        fp.write(f"Median distance: {stats.median_dist:.6f}\n")
        fp.write(f"Q1 (25%): {stats.q1_dist:.6f}\n")
        fp.write(f"Q3 (75%): {stats.q3_dist:.6f}\n")
        fp.write(f"Standard deviation: {stats.std_dev:.6f}\n")
        fp.write(f"Range: {stats.max_dist - stats.min_dist:.6f}\n\n")
        fp.write("## Optimal Threshold (Recommended)\n")
        fp.write(f"Threshold: {optimal.threshold:.6f}\n")
        fp.write(f"Confidence: {optimal.confidence:.3f}\n")
        if optimal.cluster_count > 0 or optimal.stability_score != 0.5:
            fp.write(f"Stability (overall): {optimal.stability_score:.3f}\n")
            if optimal.stability_split != 0.5 or optimal.stability_merge != 0.5:
                fp.write(f"  - Split sensitivity: {optimal.stability_split:.3f}"
                         f" (stability when threshold decreases)\n")
                fp.write(f"  - Merge sensitivity: {optimal.stability_merge:.3f}"
                         f" (stability when threshold increases)\n")
            if optimal.near_edge_count > 0:
                fp.write(f"  - Near edges evaluated: {optimal.near_edge_count}\n")
            fp.write(f"Number of clusters: {optimal.cluster_count}\n")
        fp.write(f"Suggested level: {optimal.level}\n")
        if optimal.edge_index >= 0:
            fp.write(f"Edge index: {optimal.edge_index}\n")
            fp.write(f"Gap score: {optimal.gap_score:.6f}\n")
            fp.write("Source: gap-based detection (natural breakpoint in edge "
                     "distribution)\n")
        else:
            fp.write("Source: percentile-based (median/quartile, no "
                     "significant gap detected)\n")
            fp.write("Note: This threshold is based on distribution "
                     "statistics, not natural breakpoints.\n")
            fp.write("      Consider manual adjustment (e.g., 0.01-0.05 for "
                     "species/genus level) if needed.\n")
        fp.write("\n")
        fp.write("## All Candidate Thresholds\n")
        has_stability = any(c.cluster_count > 0 or c.stability_score != 0.5
                            for c in candidates)
        if has_stability:
            fp.write("# Threshold\tConfidence\tStability_Overall\t"
                     "Stability_Split\tStability_Merge\tNear_Edges\tClusters\t"
                     "Level\tGap_Score\tEdge_Index\n")
            for c in candidates:
                fp.write(f"{c.threshold:.6f}\t{c.confidence:.3f}\t"
                         f"{c.stability_score:.3f}\t{c.stability_split:.3f}\t"
                         f"{c.stability_merge:.3f}\t{c.near_edge_count}\t"
                         f"{c.cluster_count}\t{c.level}\t{c.gap_score:.6f}\t"
                         f"{c.edge_index}\n")
        else:
            fp.write("# Threshold\tConfidence\tLevel\tGap_Score\tEdge_Index\n")
            for c in candidates:
                fp.write(f"{c.threshold:.6f}\t{c.confidence:.3f}\t{c.level}\t"
                         f"{c.gap_score:.6f}\t{c.edge_index}\n")
        fp.write("\n")
        fp.write("## Edge Length Distribution (sorted)\n")
        fp.write("# Index\tDistance\n")
        for i, dist in enumerate(stats.sorted_distances):
            fp.write(f"{i}\t{dist:.6f}\n")
    print(f"-----write threshold analysis into: {output_file}",
          file=sys.stderr)


# Source: rabbittclust_tpu/post/auto_threshold.py::select_and_report_threshold
def select_and_report_threshold(mst, output_file: str, stability: bool,
                                fallback: float, num_vertices: int = 0) -> float:
    """Run the full auto-threshold analysis; returns the *user* threshold
    unchanged (the reference only reports the recommendation)."""
    if len(mst[0]) < 2:
        print("-----WARNING: MST has too few edges for automatic threshold "
              "selection", file=sys.stderr)
        return fallback
    stats = analyze_edge_length_distribution(mst)
    candidates = find_threshold_candidates(mst, 5, 0.05, stability,
                                           num_vertices)
    optimal = select_optimal_threshold(candidates, mst)
    print_threshold_analysis(mst, stats, candidates, optimal,
                             output_file + ".threshold_analysis.txt")
    print(f"-----optimal threshold: {optimal.threshold} (confidence: "
          f"{optimal.confidence}, suggested level: {optimal.level})",
          file=sys.stderr)
    return fallback


# Source: rabbittclust_tpu/post/auto_threshold.py::report_threshold_stability
def report_threshold_stability(mst, threshold: float, output_file: str,
                               num_vertices: int = 0) -> None:
    st = compute_threshold_stability(mst, threshold, max(num_vertices, 1))
    print(f"-----threshold stability: {st.overall} (split: {st.split}, "
          f"merge: {st.merge})", file=sys.stderr)
    print(f"-----near edges evaluated: {st.near_edge_count}", file=sys.stderr)
