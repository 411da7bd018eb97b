"""Share of the traced sub-window in which no device operation ran, %."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0 or \
            run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
