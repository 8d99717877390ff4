"""Start an N-process ``--multihost`` run of a port CLI on one machine
(the port's counterpart of ``scripts/launch_multihost.py``).

On a cluster, one command runs per card:

    python -m rabbittclust_tpu_torch.cli.clust_mst --fast -l -i list \\
        -o out --multihost host0:8476,N,PROCESS_ID

This helper starts all N locally on a free port: each on its card
(``cuda:(PROCESS_ID % device_count)``; ranks that share a card ring
through host memory), or with ``virtual_cpu_devices=M`` on M CPU shards a
process (``RTC_VIRTUAL_CPU_DEVICES``).  Process 0 writes the outputs.

    python -m rabbittclust_tpu_torch.parallel.launch --nproc 2 \\
        --module mst -- --fast -l -i list.txt -o out.cluster -d 0.05

The return code is the first nonzero child's (124 when the run outlives
``timeout``: every child is then killed).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

from .multihost import _REPO, RanksTimedOut, free_port, run_ranks


def launch(nproc: int, cli_args: Sequence[str], module: str = "mst",
           virtual_cpu_devices: Optional[int] = None,
           timeout: float = 1800.0, coordinator: str = "",
           errs: Optional[List[str]] = None) -> int:
    """Run ``python -m rabbittclust_tpu_torch.cli.clust_<module>`` with
    ``cli_args`` and ``--multihost coordinator,nproc,i`` for every i in
    one process each, from the working directory; process 0's output (and
    a failing child's stderr) is passed on.  When ``errs`` is given, each
    rank's stderr is appended to it."""
    coord = coordinator or f"127.0.0.1:{free_port()}"
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, child_env.get("PYTHONPATH")) if p)
    if virtual_cpu_devices:
        child_env["RTC_VIRTUAL_CPU_DEVICES"] = str(virtual_cpu_devices)
    else:
        child_env.pop("RTC_VIRTUAL_CPU_DEVICES", None)
    cmds = [[sys.executable, "-m", f"rabbittclust_tpu_torch.cli.clust_{module}",
             *cli_args, "--multihost", f"{coord},{nproc},{pid}"]
            for pid in range(nproc)]
    try:
        rcs, outs, stderr = run_ranks(cmds, env=child_env, timeout=timeout)
    except RanksTimedOut as exc:
        sys.stderr.write(exc.stderr[0])
        print(f"the {nproc} processes timed out after {timeout} s and were "
              "killed", file=sys.stderr)
        return 124
    if errs is not None:
        errs.extend(stderr)
    sys.stdout.write(outs[0])
    for pid, (rc, err) in enumerate(zip(rcs, stderr)):
        if pid == 0 or rc != 0:
            sys.stderr.write(err)
    return next((rc for rc in rcs if rc != 0), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        usage="%(prog)s --nproc N [options] -- <clust CLI args>")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--module", default="mst",
                    choices=["mst", "greedy", "leiden", "dbscan"])
    ap.add_argument("--virtual-cpu-devices", type=int, default=None)
    ap.add_argument("--coordinator", default="",
                    help="coordinator address (default: 127.0.0.1:freeport)")
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("cli_args", nargs=argparse.REMAINDER,
                    help="arguments passed on to the clust CLI (after --)")
    args = ap.parse_args(argv)
    cli = args.cli_args
    if cli and cli[0] == "--":
        cli = cli[1:]
    return launch(args.nproc, cli, module=args.module,
                  virtual_cpu_devices=args.virtual_cpu_devices,
                  timeout=args.timeout, coordinator=args.coordinator)


if __name__ == "__main__":
    sys.exit(main())
