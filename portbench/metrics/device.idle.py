"""Share of the profiled job's wall in which no kernel, copy or memset ran
on the card; percent."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
