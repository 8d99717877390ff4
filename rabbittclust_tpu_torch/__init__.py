"""rabbittclust_tpu_torch — the PyTorch/CUDA port of rabbittclust_tpu.

The JAX package ``rabbittclust_tpu`` is the reference.  This package runs
the same workflows on an NVIDIA GPU through hand-written CUDA kernels
(``csrc/``), and shares the JAX package's backend-free host code
(sketching, distances, Kruskal, persistence, outputs) by import, through
``host.py``.  It never imports ``jax``.

Layout mirrors the JAX package:
    ops/intersect.py  exact pair counts: kernels K4 / K5b and their plain
                      torch versions
    ops/engine.py     dense exact-MST engine (compact pull)
    ops/pack.py       packed sketch planes on the device
    ops/bitmap.py     mask bit-packing
    workflows.py      clust-mst --fast --device workflows
    cli/clust_mst.py  entry point
    kernels/_build.py nvcc build of csrc/*.cu at first use
    device.py         explicit device selection (no CPU fallback)
"""
