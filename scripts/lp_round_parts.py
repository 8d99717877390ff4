#!/usr/bin/env python
"""Where the time of K2's round goes, at the mesh LP's slab shape, on the
card.

Builds ``labelprop_round.cu`` of each given port package three times, as
it is and with a part taken out by a text edit of a copy of the source:

* ``whole`` — the source as it is;
* ``no stage/flush`` — a block neither stages its column labels and minima
  into shared memory nor flushes its column minima (the loop bodies
  removed);
* ``no scan`` — the masks are still loaded, but each 16-byte piece is
  folded into the count with one popcount instead of being scanned bit by
  bit (no label gate, no minima).

Each build is its own shared library (nvcc with the port's flags), and
each times ``rtc_lp_round`` with CUDA events over the same inputs, in
turns (the variants in order, then in reverse): one slab of the mesh LP
engine at N = 131,072 over 8 shards, 5 steps of 16,384 x 16,384 bits,
made here with the planted-cluster pattern of chip_smoke.py's corpus (bit
(i, j) where i and j share i % 64, 9 in 10 of them kept, and stray bits at
1e-4), mixed labels (half the genomes their cluster's, half their own) and
a clear list of 400 bits.  Only the whole build's output is meaningful;
the others time the work left.

Usage (on a machine with the card and nvcc):
    python scripts/lp_round_parts.py [--src DIR ...] [--reps 20]
DIR holds a ``rabbittclust_tpu_torch`` package (default: this checkout's).
Prints one line per (source, variant) and the card's name and power limit.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SENT = 1 << 30
# (name, [(pattern, replacement)]): each pattern must match at least once
VARIANTS = [
    ("whole", []),
    ("no stage/flush", [
        (r"lc\[slot\(c\)\] = labels\[c0 \+ c\];\s*cmin\[c\] = SENT;", ""),
        (r"if \(m < SENT\) atomicMin\(col_p \+ c0 \+ c, m\);", "(void)m;"),
    ]),
    ("no scan", [
        (r"const uint32_t w\[4\] = \{([^{}]+?)\.x, \1\.y, \1\.z, \1\.w\};",
         r"mine += __popc(\1.x | \1.y | \1.z | \1.w) & 1; "
         r"const uint32_t w[4] = {0u, 0u, 0u, 0u};"),
    ]),
]


def build_variant(pkg, edits, out_dir, tag):
    """The shared library of ``pkg``'s labelprop_round.cu with ``edits``."""
    from rabbittclust_tpu_torch.kernels import _build
    csrc = os.path.join(pkg, "csrc")
    with open(os.path.join(csrc, "labelprop_round.cu")) as f:
        src = f.read()
    for pat, rep in edits:
        src, n = re.subn(pat, rep, src)
        if n == 0:
            raise RuntimeError(f"{tag}: the edit {pat!r} matched nothing")
    path = os.path.join(out_dir, f"{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"{tag}.so")
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-I", csrc, "-o", lib, path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stdout}"
                           f"{proc.stderr}")
    so = ctypes.CDLL(lib)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.rtc_lp_round.restype = ci
    so.rtc_lp_round.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, ci, ci, vp,
                                vp]
    return so


def slab_inputs(dev, n=131072, n_dev=8, top=7, seed=6):
    """The slab of shard ``top`` (steps 0..4), its geometry, mixed labels
    and a clear list of 400 bits over set bits of random bytes."""
    from rabbittclust_tpu_torch.ops import bitmap as bm
    shard = n // n_dev
    n_steps = n_dev // 2 + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.arange(shard, device=dev)
    slab = torch.empty((n_steps, shard, shard // 8), dtype=torch.uint8,
                       device=dev)
    c0s = [((top - t) % n_dev) * shard for t in range(n_steps)]
    for t, c0 in enumerate(c0s):
        m = (rows[:, None] % 64) == ((rows[None, :] + c0) % 64)
        m &= torch.rand((shard, shard), generator=g, device=dev) < 0.9
        m |= torch.rand((shard, shard), generator=g, device=dev) < 1e-4
        slab[t] = bm.pack_mask_u8(m)
        del m
    geo = torch.tensor([[top * shard] * n_steps, c0s, [1] * n_steps],
                       dtype=torch.int32, device=dev)
    rng = np.random.default_rng(seed)
    ids = np.arange(n)
    labels = np.where(rng.random(n) < 0.5, ids % 64, 64 + ids)
    t, r, b = (x.cpu().numpy() for x in torch.nonzero(slab[:, ::97],
                                                      as_tuple=True))
    pick = rng.permutation(len(t))[:400]
    clr = np.zeros((4, 1024), dtype=np.int32)
    clr[:, :len(pick)] = [t[pick], 97 * r[pick], b[pick],
                          1 << rng.integers(0, 8, len(pick))]
    return (slab, torch.from_numpy(labels.astype(np.int32)).to(dev),
            torch.from_numpy(clr).to(dev), geo, shard, n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", default=None,
                    help="a directory holding rabbittclust_tpu_torch/")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lp_round_parts: no CUDA GPU visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}")
    slab, labels, clr, geo, shard, n_pad = slab_inputs(dev)
    fused = torch.empty(1 + 2 * n_pad, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    libs = []
    with tempfile.TemporaryDirectory() as tmp:
        for q, root in enumerate(args.src or [ROOT]):
            pkg = os.path.join(os.path.abspath(root),
                               "rabbittclust_tpu_torch")
            for v, (name, edits) in enumerate(VARIANTS):
                libs.append((f"{root} {name}", build_variant(
                    pkg, edits, tmp, f"s{q}v{v}")))
        times = {tag: [] for tag, _ in libs}
        for tag, so in libs + libs[::-1]:
            work = slab.clone()

            def run():
                rc = so.rtc_lp_round(
                    work.data_ptr(), labels.data_ptr(), clr.data_ptr(),
                    clr.shape[1], geo[0].data_ptr(), geo[1].data_ptr(),
                    geo[2].data_ptr(), slab.shape[0], shard, n_pad,
                    fused.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{tag}: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            for _ in range(args.reps):
                run()
            stop.record()
            torch.cuda.synchronize()
            times[tag].append(start.elapsed_time(stop) / args.reps)
            del work
    bound = (slab.numel() + 4 * (labels.numel() + clr.numel()
                                 + fused.numel())) / 3.35e12 * 1e3
    for tag, ms in times.items():
        print(f"{tag}: {' / '.join(f'{x:.4f}' for x in ms)} ms a round "
              f"(CUDA events over {args.reps} calls, the prepare kernel "
              f"in; bytes bound {bound:.4f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
