"""The benchmark of the PyTorch/CUDA port (``rabbittclust_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card.  The
folder holds the yardstick: the traffic generator (``corpus.py``), the
plain reference (``reference.py``), the comparison that decides
``correct`` (``judge.py``), the table of peaks and the roofline counts
(``roofline.py``), the reading of the profiler's trace (``trace.py``), one
reader a per-layer metric (``metrics/<name>.py``), the configurations
(``configs/<name>.json``) and the traffic mixes (``traffic/<name>.json``).
Nothing here imports JAX or the JAX package.
"""
