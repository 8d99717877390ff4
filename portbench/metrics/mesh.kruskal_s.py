"""Mesh engine, host: seconds of the pads' drop, the float64 distances and
the compiled Kruskal over the ring's candidates (the span
``mesh.kruskal``, ``distributed_mst``); mean over the window's jobs that
opened it."""


def read(run):
    vals = [j["stats"]["spans"]["mesh.kruskal"]["total_s"] for j in run.jobs
            if "mesh.kruskal" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
