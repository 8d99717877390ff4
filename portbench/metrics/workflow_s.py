"""Seconds of a job outside its engine: the job's wall less the engine's
own ``clusters_s`` (MST-free) or ``mst_s`` (dense engine), so output
writing, saves and dispatch; mean over the window's jobs."""


def read(run):
    vals = []
    for j in run.jobs:
        eng = j["stats"].get("clusters_s", j["stats"].get("mst_s"))
        if eng is not None:
            vals.append(j["wall_s"] - eng)
    return sum(vals) / len(vals) if vals else None
