"""Mesh engine: candidate edges the exact ring hands to ``kruskal`` a job,
the pads dropped (the counter ``mesh.candidates``,
``parallel/dist_engine.py``); mean over the window's jobs that counted
them."""


def read(run):
    vals = [j["stats"]["counters"]["mesh.candidates"] for j in run.jobs
            if "mesh.candidates" in j["stats"].get("counters", {})]
    return sum(vals) / len(vals) if vals else None
