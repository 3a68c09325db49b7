"""% of the traced window's time that the steps' counted work needs at
the card's peaks: the least time of each group of a step's work
(work/<model>.py), summed, times the steps, over the window."""

from benchmark.metrics_common import step_least_s


def read(run):
    if run.trace is None or not run.rec["steps"] or not run.trace.kernels:
        return None
    return 100 * step_least_s(run) * run.rec["steps"] / run.trace.window_s
