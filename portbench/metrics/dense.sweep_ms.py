"""Dense engine, device: milliseconds of K4's tile sweep by CUDA events
(``stats["sweep_ms"]``); mean over the window's jobs that ran the dense
engine."""


def read(run):
    vals = [j["stats"]["sweep_ms"]
            for j in run.jobs if "sweep_ms" in j["stats"]]
    return sum(vals) / len(vals) if vals else None
