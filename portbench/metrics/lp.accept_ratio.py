"""LP engine, host: the proposals' share that the exact verify kept as
forest edges (the counters ``lp.kept`` over ``lp.proposals``,
``ops/labelprop.py``): useful verifies over attempts; mean over the
window's jobs that proposed a pair."""


def read(run):
    vals = []
    for j in run.jobs:
        c = j["stats"].get("counters", {})
        if c.get("lp.proposals"):
            vals.append(c.get("lp.kept", 0) / c["lp.proposals"])
    return sum(vals) / len(vals) if vals else None
