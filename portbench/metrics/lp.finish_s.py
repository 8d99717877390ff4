"""LP engine, host: seconds of the finish, the sort of the kept edges and
the BFS of the clusters (the span ``lp.finish``, ``ops/labelprop.py``);
mean over the window's jobs that opened it."""


def read(run):
    vals = [j["stats"]["spans"]["lp.finish"]["total_s"] for j in run.jobs
            if "lp.finish" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
