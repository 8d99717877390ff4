"""LP engine, host: seconds of the signature pack and its upload
(``LP_STATS`` ``pack_s + stage_s``); mean over the window's jobs that
ran the LP engine."""


def read(run):
    vals = [j["lp_stats"]["pack_s"] + j["lp_stats"]["stage_s"]
            for j in run.jobs if j["lp_stats"]["panels"] > 0]
    return sum(vals) / len(vals) if vals else None
