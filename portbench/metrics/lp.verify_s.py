"""LP engine, host: seconds of the exact verify and merge of the proposals
(``LP_STATS["verify_s"]``); mean over the window's jobs that ran the LP
engine."""


def read(run):
    vals = [j["lp_stats"]["verify_s"]
            for j in run.jobs if j["lp_stats"]["panels"] > 0]
    return sum(vals) / len(vals) if vals else None
