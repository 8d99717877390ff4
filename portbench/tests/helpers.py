"""Small corpora and cells for the benchmark's CPU tests."""

import json
import os

import numpy as np
import torch

from portbench import corpus, harness

SPEC_PATH = os.path.join(harness.ROOT, "BENCHMARK.json")
CPU = torch.device("cpu")
SEED = 2 ** 33 + 101  # more than 32 bits, as the driver's seeds are


def spec():
    with open(SPEC_PATH) as f:
        return json.load(f)


def small_traffic(name="refseq", genomes=160, species=12):
    """The traffic ``name`` with ``species`` species to ``genomes``."""
    with open(os.path.join(harness.HERE, "traffic", name + ".json")) as f:
        t = json.load(f)
    return dict(t, genomes_per_species=genomes / species)


def small_cell(workload, genomes=160, species=12):
    cell = harness.Cell.load(spec(), workload)
    cell.traffic = small_traffic(cell.cell["traffic"], genomes, species)
    cell.config = dict(cell.config, genomes=genomes)
    return cell


def small_corpus(seed=SEED, genomes=160, species=12):
    return corpus.generate(small_traffic(genomes=genomes, species=species),
                           genomes, 0.05, 22, seed, CPU)


def brute_counts(c):
    """(n, n) int64 common counts of every pair, by set intersection."""
    hs = c.hashes()
    out = np.zeros((c.n, c.n), dtype=np.int64)
    for i in range(c.n):
        for j in range(i):
            out[i, j] = out[j, i] = len(np.intersect1d(hs[i], hs[j],
                                                       assume_unique=True))
    return out
