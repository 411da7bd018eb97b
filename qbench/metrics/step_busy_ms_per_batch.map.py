"""Device busy time (union of kernels, copies and sets) in the traced
sub-window per batch consumed in it, ms."""


def read(run):
    if not run.trace or not run.traced_batches or run.trace["busy_s"] <= 0:
        return None
    return 1e3 * run.trace["busy_s"] / run.traced_batches
