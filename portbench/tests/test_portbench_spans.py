"""The readers of the program's spans and counters: each gives the mean
over the window's jobs that hold what it reads, and None where no job
does, as at a program that opens no spans."""

import pytest

from portbench import harness

# reader: (what a job's stats hold for it, the number a job gives)
SPANS = {
    "lp.csr_s": ("lp.csr", "total_s"),
    "lp.finish_s": ("lp.finish", "total_s"),
    "lp.pull_wait_s": ("lp.pull", "total_s"),
    "dense.decode_s": ("dense.decode", "total_s"),
    "mst.save_s": ("mst.save", "total_s"),
    "write.cluster_s": ("write.cluster", "total_s"),
    "job.unspanned_s": ("job", "self_s"),
}


def span_job(name, total, self_s):
    return {"wall_s": 1.0, "lp_stats": {"panels": 0}, "stats": {
        "spans": {name: {"n": 2, "total_s": total, "self_s": self_s},
                  "other": {"n": 1, "total_s": 9.0, "self_s": 9.0}},
        "counters": {}}}


def bare_job():
    """A job of a program without spans: its stats hold neither."""
    return {"wall_s": 1.0, "lp_stats": {"panels": 1}, "stats": {}}


def run_of(jobs):
    return harness.Run(config={}, traffic={}, corpus=None, jobs=jobs)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader_means_the_jobs_that_hold_the_span(metric):
    name, field = SPANS[metric]
    jobs = [span_job(name, 0.5, 0.25), span_job(name, 1.5, 0.75),
            span_job("elsewhere", 7.0, 7.0), bare_job()]
    want = 1.0 if field == "total_s" else 0.5
    assert harness.read_metric(metric, run_of(jobs)) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(SPANS) + ["lp.accept_ratio"])
def test_reader_finds_nothing_without_the_span(metric):
    jobs = [bare_job(), span_job("elsewhere", 1.0, 1.0)]
    assert harness.read_metric(metric, run_of(jobs)) is None


def test_accept_ratio_is_kept_over_proposals():
    def counted(kept, proposals):
        job = span_job("job", 1.0, 0.0)
        job["stats"]["counters"] = {"lp.kept": kept,
                                    "lp.proposals": proposals}
        return job
    jobs = [counted(90, 100), counted(50, 100), counted(0, 0), bare_job()]
    assert harness.read_metric("lp.accept_ratio", run_of(jobs)) == \
        pytest.approx(0.7)
