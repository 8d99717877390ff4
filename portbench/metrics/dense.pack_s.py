"""Dense engine, host: seconds of the numpy pack of the sketches
(``stats["pack_s"]``); mean over the window's jobs that ran the dense
engine."""


def read(run):
    vals = [j["stats"]["pack_s"]
            for j in run.jobs if "pack_s" in j["stats"]]
    return sum(vals) / len(vals) if vals else None
