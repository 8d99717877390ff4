"""K1's share of its roofline in the profiled job: the least time of the
filter over all n (n - 1) / 2 pairs of the corpus (``roofline.k1_need``
at the .b1 rate) over the time of the kernels named filter_mask_kernel;
percent."""

from portbench import roofline, trace


def read(run):
    if run.trace is None:
        return None
    spent = trace.kernel_seconds(run.trace, "filter_mask_kernel")
    if spent <= 0:
        return None
    n = run.corpus.n
    least = roofline.least_time(*roofline.k1_need(n * (n - 1) / 2, n),
                                roofline.B1_OPS)
    return 100.0 * least / spent
