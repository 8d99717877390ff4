"""Mesh engine, host: seconds of the pull of the ring's positions and
common counts and their decode into global pairs (the span
``mesh.decode``, ``distributed_candidate_edges``); mean over the
window's jobs that opened it."""


def read(run):
    vals = [j["stats"]["spans"]["mesh.decode"]["total_s"] for j in run.jobs
            if "mesh.decode" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
