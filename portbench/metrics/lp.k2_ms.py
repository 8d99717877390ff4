"""LP engine, device: milliseconds of K2's rounds by CUDA events
(``LP_STATS["round_ms"]``); mean over the window's jobs that ran the LP
engine."""


def read(run):
    vals = [j["lp_stats"]["round_ms"]
            for j in run.jobs if j["lp_stats"]["panels"] > 0]
    return sum(vals) / len(vals) if vals else None
