"""LP engine, device: milliseconds of K1's mask builds by CUDA events
(``LP_STATS["build_ms"]``); mean over the window's jobs that ran the LP
engine."""


def read(run):
    vals = [j["lp_stats"]["build_ms"]
            for j in run.jobs if j["lp_stats"]["panels"] > 0]
    return sum(vals) / len(vals) if vals else None
