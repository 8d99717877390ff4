"""LP engine: K2 rounds a job (``LP_STATS["rounds"]``); mean over the
window's jobs that ran the LP engine."""


def read(run):
    vals = [j["lp_stats"]["rounds"]
            for j in run.jobs if j["lp_stats"]["panels"] > 0]
    return sum(vals) / len(vals) if vals else None
