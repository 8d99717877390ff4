"""Workflow: seconds of the MST run's saves, ``edge.mst`` and the genome
info (the span ``mst.save``, ``workflows.py::_save_mst_run``); mean over
the window's jobs that opened it."""


def read(run):
    vals = [j["stats"]["spans"]["mst.save"]["total_s"] for j in run.jobs
            if "mst.save" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
