"""Synthetic benchmark data generators (reference benchmark/simulate).

  * simulate_long_sequences — numSeedSeqs clusters x numEachClusts mutated
    copies at a given mutation rate + .groundTruth file (exact-recovery test
    for Mash clustering);
  * create_containment — random-length fragments of seed genomes (tests the
    AAF containment mode).

The port's copy of ``rabbittclust_tpu/evaltools/simulate.py``.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from typing import List


# Source: rabbittclust_tpu/evaltools/simulate.py::_rand_seq
def _rand_seq(rng: random.Random, n: int) -> str:
    return "".join(rng.choice("ACGT") for _ in range(n))


# Source: rabbittclust_tpu/evaltools/simulate.py::_mutate
def _mutate(rng: random.Random, s: str, rate: float) -> str:
    out = []
    for ch in s:
        if rng.random() < rate:
            out.append(rng.choice("ACGT"))
        else:
            out.append(ch)
    return "".join(out)


# Source: rabbittclust_tpu/evaltools/simulate.py::_write_fasta
def _write_fasta(path: str, name: str, seq: str) -> None:
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for k in range(0, len(seq), 80):
            f.write(seq[k:k + 80] + "\n")


# Source: rabbittclust_tpu/evaltools/simulate.py::simulate_long_sequences
def simulate_long_sequences(out_dir: str, num_seeds: int, per_cluster: int,
                            length: int, mutation: float,
                            seed: int = 1) -> List[str]:
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    files = []
    gt_path = os.path.join(out_dir, "simulated.groundTruth")
    with open(gt_path, "w") as gt:
        gt.write("accession\ttaxid\torganismName\n")
        for ci in range(num_seeds):
            base = _rand_seq(rng, length)
            for m in range(per_cluster):
                acc = f"SIM_{ci:05d}.{m}"
                fp = os.path.join(out_dir, f"{acc}.fna")
                _write_fasta(fp, acc, _mutate(rng, base, mutation))
                files.append(fp)
                gt.write(f"{acc}\t{1000 + ci}\tsimulated cluster {ci}\n")
    list_path = os.path.join(out_dir, "simulated.list")
    with open(list_path, "w") as f:
        f.write("\n".join(files) + "\n")
    return files


# Source: rabbittclust_tpu/evaltools/simulate.py::create_containment
def create_containment(out_dir: str, num_seeds: int, per_cluster: int,
                       length: int, min_frac: float = 0.2,
                       seed: int = 1) -> List[str]:
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    files = []
    gt_path = os.path.join(out_dir, "containment.groundTruth")
    with open(gt_path, "w") as gt:
        gt.write("accession\ttaxid\torganismName\n")
        for ci in range(num_seeds):
            base = _rand_seq(rng, length)
            for m in range(per_cluster):
                acc = f"FRAG_{ci:05d}.{m}"
                if m == 0:
                    s = base
                else:
                    frag_len = rng.randint(int(length * min_frac), length)
                    start = rng.randint(0, length - frag_len)
                    s = base[start:start + frag_len]
                fp = os.path.join(out_dir, f"{acc}.fna")
                _write_fasta(fp, acc, s)
                files.append(fp)
                gt.write(f"{acc}\t{2000 + ci}\tcontainment cluster {ci}\n")
    list_path = os.path.join(out_dir, "containment.list")
    with open(list_path, "w") as f:
        f.write("\n".join(files) + "\n")
    return files


# Source: rabbittclust_tpu/evaltools/simulate.py::main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["long", "containment"])
    ap.add_argument("out_dir")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--per-cluster", type=int, default=5)
    ap.add_argument("--length", type=int, default=100000)
    ap.add_argument("--mutation", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if args.mode == "long":
        files = simulate_long_sequences(args.out_dir, args.seeds,
                                        args.per_cluster, args.length,
                                        args.mutation, args.seed)
    else:
        files = create_containment(args.out_dir, args.seeds,
                                   args.per_cluster, args.length,
                                   seed=args.seed)
    print(f"wrote {len(files)} genomes to {args.out_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
