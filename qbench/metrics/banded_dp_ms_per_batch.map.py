"""Time of the kernels named banded_dp in the traced sub-window per batch
consumed in it, ms; nothing where no such kernel ran."""


def read(run):
    if not run.trace or not run.traced_batches:
        return None
    t = sum(v for k, v in run.trace["kernels"].items() if "banded_dp" in k)
    return 1e3 * t / run.traced_batches if t > 0 else None
