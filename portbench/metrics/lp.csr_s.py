"""LP engine, host: seconds of the CSR flatten of the sketches that the
exact verify reads (the span ``lp.csr``, ``ops/labelprop.py``); mean over
the window's jobs that opened it."""


def read(run):
    vals = [j["stats"]["spans"]["lp.csr"]["total_s"] for j in run.jobs
            if "lp.csr" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
