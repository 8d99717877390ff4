"""Workflow: seconds of a job's wall that no span explains, the self time
of the root span ``job`` (``utils/profiling.py::job``): its duration less
what its child spans cover; mean over the window's jobs that opened it."""


def read(run):
    vals = [j["stats"]["spans"]["job"]["self_s"] for j in run.jobs
            if "job" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
