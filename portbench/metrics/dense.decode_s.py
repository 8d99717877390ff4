"""Dense engine, host: seconds of the pull and decode of the packed masks
into candidate pairs (the spans ``dense.decode``, ``ops/engine.py``); mean
over the window's jobs that opened them."""


def read(run):
    vals = [j["stats"]["spans"]["dense.decode"]["total_s"] for j in run.jobs
            if "dense.decode" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
