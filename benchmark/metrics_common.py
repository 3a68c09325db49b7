"""Arithmetic the metric readers share."""

from benchmark.peaks import least_s


def step_least_s(run, group=None) -> float:
    """Least seconds of one step's work on this card (of one group of it
    where `group` is given)."""
    work = run.module("work")
    return sum(least_s(f, b, u) for g, f, b, u in
               work.train_step(run.cfg, run.traffic["batch_rows"])
               if group is None or g == group)


def group_share(run, group, is_kernel):
    """% of the traced steps' device time in `is_kernel`'s kernels that
    `group`'s least time is."""
    if run.trace is None or not run.rec["steps"]:
        return None
    s = run.trace.seconds_where(is_kernel)
    if not s:
        return None
    return 100 * step_least_s(run, group) * run.rec["steps"] / s


def idle_share(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 100 * (1 - run.trace.busy_s() / run.trace.window_s)
