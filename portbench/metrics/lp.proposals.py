"""LP engine: proposals verified on the host a job
(``LP_STATS["proposals"]``); mean over the window's jobs that ran the LP
engine."""


def read(run):
    vals = [j["lp_stats"]["proposals"]
            for j in run.jobs if j["lp_stats"]["panels"] > 0]
    return sum(vals) / len(vals) if vals else None
