"""rabbittclust_tpu_torch — the PyTorch/CUDA port of rabbittclust_tpu.

The JAX package ``rabbittclust_tpu`` is the reference.  This package runs
the same workflows on an NVIDIA GPU through hand-written CUDA kernels
(``csrc/``).  It keeps its own copies of the JAX package's backend-free
host code (sketching, distances, Kruskal, persistence, outputs, the
evaluation tools), each at the relative path of its original and marked
``# Source:``, and imports nothing of ``rabbittclust_tpu`` and no ``jax``.
Only the native C++ host library ``native/librtc_native.so`` at the
repository root is shared.

Layout mirrors the JAX package:
    ops/intersect.py    exact pair counts: kernels K4 / K5b and their plain
                        torch versions
    ops/engine.py       dense exact-MST engine (compact pull)
    ops/pack.py         packed sketch planes on the device
    ops/bitmap.py       bitmap candidate filter: kernel K1, the stream
                        engine's generator, mask bit-packing, kernel K3
    ops/labelprop.py    resident-mask label-propagation engine: kernel K2
    ops/cluster_fast.py MST-free dispatcher (stream / LP, -t 1 order)
    ops/greedy_device.py greedy over one K1 sweep and a host replay, and
                        the batched greedy over kernel K6
    ops/transfer.py     device-to-host pulls on events
    ops/sketch_device.py the device KSSD sketcher (RTC_DEVICE_SKETCH=1):
                        kernel K7
    ops/extra_pairs.py  WMH / OMH positional token matches: kernel K8
    parallel/dist_engine.py
                        the mesh ring engines over a list of devices
                        (exact, bitmap and mask rings, the mesh LP round)
    parallel/multihost.py, parallel/launch.py, parallel/dryrun.py
                        the mesh over torch.distributed processes
                        (--multihost), its launcher and its dry run
    workflows.py        clust-mst / clust-greedy --device workflows and
                        their output tail
    workflows_extra.py  clust-mst --sketch-func WMH / HLL / OMH
    workflows_dist.py   the sharded ingest of --multihost
    workflows_db.py, workflows_minhash_append.py
                        RepDB (--db, --buildDB) and the MinHash --append
    cli/clust_mst.py, cli/clust_greedy.py, cli/clust_dbscan.py,
    cli/clust_leiden.py entry points; cli/common.py their flags,
                        cli/repdb.py the RepDB verbs
    state/              sketch folders, edge.mst, the cluster states
                        (--save-rep, --append) and RepDB files
    sketch/ io/ distance/ cluster/ post/
                        host code: KSSD, MinHash and WMH / HLL / OMH
                        sketching, FASTA input, distances, Kruskal and
                        forest cuts, the native greedy, DBSCAN and Leiden
                        engines, trees / auto-threshold / dedup
    evaltools/          offline scoring of .cluster files (NMI, F1,
                        purity), representatives, newick trees, simulated
                        corpora, taxonomy and genus analyses
    utils/native.py     the native library's loader
    utils/profiling.py  spans and counters, recorded in the job scope
                        of compute_kssd_clusters (a record_function range
                        only under a profiler session), CUDA-event timers,
                        and RTC_PROFILE_DIR's torch.profiler traces
    kernels/_build.py   nvcc build of csrc/*.cu and g++ build of
                        hostsrc/*.cpp (the Kruskal), each at first use
    device.py           explicit device selection (no CPU fallback)

Importing the package tunes glibc's malloc (``_tune_malloc``;
``RTC_MALLOC_REUSE=0`` leaves it as it is).
"""

__version__ = "0.1.0"


# Source: rabbittclust_tpu/__init__.py::_tune_malloc
def _tune_malloc() -> None:
    """Keep large freed buffers on the glibc heap for reuse.

    By default glibc mmaps every allocation over 128 KB and munmaps it on
    free, so each reuse of a multi-GB sketch / CSR / pack buffer faults its
    pages in again.  Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD to 1 GiB
    keeps such buffers on the heap, where the next allocation of that size
    reuses memory already faulted in; it trades retained RSS for wall time
    (``scripts/malloc_reuse_times.py`` measures both).
    ``RTC_MALLOC_REUSE=0`` keeps glibc's defaults."""
    import os as _os
    if _os.environ.get("RTC_MALLOC_REUSE", "1") == "0":
        return
    try:
        import ctypes as _ct
        _libc = _ct.CDLL("libc.so.6", use_errno=True)
        _libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        _libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_malloc()
