"""Mesh engine, host: seconds of the exact ring, every step of every shard
and the hops between the cards (the span ``mesh.ring``,
``parallel/dist_engine.py::_ring``); mean over the window's jobs that
opened it."""


def read(run):
    vals = [j["stats"]["spans"]["mesh.ring"]["total_s"] for j in run.jobs
            if "mesh.ring" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
