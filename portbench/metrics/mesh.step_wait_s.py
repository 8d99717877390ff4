"""Mesh engine, host: seconds of the ring steps' one sync each, K3's
enqueue and the pull of its total, where the host waits for a card's
kernels (the spans ``mesh.step_wait``, ``ring_edges_step``); mean over
the window's jobs that opened them."""


def read(run):
    vals = [j["stats"]["spans"]["mesh.step_wait"]["total_s"] for j in run.jobs
            if "mesh.step_wait" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
