"""Dense engine: candidate pairs decoded and counted a job
(``stats["candidates"]``); mean over the window's jobs that ran the
dense engine."""


def read(run):
    vals = [j["stats"]["candidates"]
            for j in run.jobs if "candidates" in j["stats"]]
    return sum(vals) / len(vals) if vals else None
