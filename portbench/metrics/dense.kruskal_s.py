"""Dense engine, host: seconds of the Kruskal passes
(``stats["kruskal_s"]``); mean over the window's jobs that ran the dense
engine."""


def read(run):
    vals = [j["stats"]["kruskal_s"]
            for j in run.jobs if "kruskal_s" in j["stats"]]
    return sum(vals) / len(vals) if vals else None
