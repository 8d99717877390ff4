"""Device: GiB of the fullest card of the mesh, the largest
``torch.cuda.max_memory_allocated`` over its devices at the end of a mesh
job (the counter ``mesh.card_peak_bytes``, ``parallel/dist_engine.py``);
mean over the window's jobs that counted it."""


def read(run):
    vals = [j["stats"]["counters"]["mesh.card_peak_bytes"] / 2 ** 30
            for j in run.jobs
            if "mesh.card_peak_bytes" in j["stats"].get("counters", {})]
    return sum(vals) / len(vals) if vals else None
