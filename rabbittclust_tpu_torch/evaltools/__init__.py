"""Offline evaluation tools of the port (counterpart of
``rabbittclust_tpu/evaltools/``): scoring of ``.cluster`` files,
representatives, newick trees, simulated corpora, taxonomy and genus
analyses.  Pure host code; each module runs as ``python -m
rabbittclust_tpu_torch.evaltools.<tool>`` with the arguments of its
original."""
