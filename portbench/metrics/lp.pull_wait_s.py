"""LP engine, host: seconds the host waits for the card's proposals, K2's
round and the copy behind it (the spans ``lp.pull``, ``ops/labelprop.py``);
mean over the window's jobs that opened them."""


def read(run):
    vals = [j["stats"]["spans"]["lp.pull"]["total_s"] for j in run.jobs
            if "lp.pull" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
