"""K4's share of its roofline in the profiled job (its mask mode, the
dense engine's sweep): the least time of the pairs' shared hashes at the
INT32 rate, or of the hashes read and the mask written
(``roofline.k4_mask``), over the time of the kernels named
pair_tiles_kernel; percent."""

from portbench import roofline, trace


def read(run):
    if run.trace is None:
        return None
    spent = trace.kernel_seconds(run.trace, "pair_tiles_kernel")
    if spent <= 0:
        return None
    c = run.corpus
    need = roofline.k4_mask(c.n, len(c.flat),
                            roofline.shared_hash_matches(c.flat))
    return 100.0 * roofline.least_time(*need, roofline.INT32_OPS) / spent
