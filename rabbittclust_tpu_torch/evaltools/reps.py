"""getRepresentativeList equivalent: extract the first genome of each
cluster from a .cluster file (reference benchmark/evaluation tool).

The port's copy of ``rabbittclust_tpu/evaltools/reps.py``.
"""

from __future__ import annotations

import argparse
import sys

from .evaluate import parse_cluster_file


# Source: rabbittclust_tpu/evaltools/reps.py::main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cluster_file")
    ap.add_argument("output")
    ap.add_argument("-l", dest="by_file", action="store_true",
                    help="cluster file was produced in by-file (-l) mode")
    args = ap.parse_args(argv)
    clusters = parse_cluster_file(args.cluster_file, args.by_file)
    with open(args.output, "w") as f:
        for c in clusters:
            if c:
                f.write(c[0] + "\n")
    print(f"wrote {sum(1 for c in clusters if c)} representatives to "
          f"{args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
