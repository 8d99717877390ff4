"""Dense engine, device: milliseconds of K5b's exact counts by CUDA events
(``stats["pair_common_ms"]``); mean over the window's jobs that ran the
dense engine."""


def read(run):
    vals = [j["stats"]["pair_common_ms"]
            for j in run.jobs if "pair_common_ms" in j["stats"]]
    return sum(vals) / len(vals) if vals else None
