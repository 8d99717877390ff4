"""rabbittclust_tpu_torch — the PyTorch/CUDA port of rabbittclust_tpu.

The JAX package ``rabbittclust_tpu`` is the reference.  This package runs
the same workflows on an NVIDIA GPU through hand-written CUDA kernels
(``csrc/``).  It keeps its own copies of the JAX package's backend-free
host code (sketching, distances, Kruskal, persistence, outputs), each at
the relative path of its original and marked ``# Source:``, and imports
nothing of ``rabbittclust_tpu`` and no ``jax``.  Only the native C++ host
library ``native/librtc_native.so`` at the repository root is shared.

Layout mirrors the JAX package:
    ops/intersect.py    exact pair counts: kernels K4 / K5b and their plain
                        torch versions
    ops/engine.py       dense exact-MST engine (compact pull)
    ops/pack.py         packed sketch planes on the device
    ops/bitmap.py       bitmap candidate filter: kernel K1, the stream
                        engine's generator, mask bit-packing
    ops/labelprop.py    resident-mask label-propagation engine: kernel K2
    ops/cluster_fast.py MST-free dispatcher (stream / LP, -t 1 order)
    ops/greedy_device.py greedy over one K1 sweep and a host replay, and
                        the batched greedy over kernel K6
    parallel/dist_engine.py
                        the mesh ring engines over a list of devices
                        (exact, bitmap and mask rings, the mesh LP round)
    ops/transfer.py     device-to-host pulls on events
    ops/sketch_device.py the device KSSD sketcher (RTC_DEVICE_SKETCH=1):
                        kernel K7
    ops/extra_pairs.py  WMH / OMH positional token matches: kernel K8
    workflows.py        clust-mst / clust-greedy --device workflows and
                        their output tail
    workflows_extra.py  clust-mst --sketch-func WMH / HLL / OMH
    cli/clust_mst.py, cli/clust_greedy.py
                        entry points; cli/common.py their flags and the
                        table of arms not ported yet
    sketch/ io/ state/ distance/ cluster/ post/ utils/
                        host code: KSSD, MinHash and WMH / HLL / OMH
                        sketching, FASTA
                        input, persistence, distances, Kruskal and forest
                        cuts, the native greedy engines, trees /
                        auto-threshold / dedup, the native loader
    kernels/_build.py   nvcc build of csrc/*.cu at first use
    device.py           explicit device selection (no CPU fallback)
"""
