"""Workflow: seconds of the ``.cluster`` writer, format and write, where
it runs (the spans ``write.cluster``,
``state/cluster_io.py::write_cluster_file``); mean over the window's jobs
that opened them."""


def read(run):
    vals = [j["stats"]["spans"]["write.cluster"]["total_s"]
            for j in run.jobs
            if "write.cluster" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
