"""Device ms a step of kernels K1-K4 (by name, from the trace)."""

from benchmark.kernels import is_l1


def read(run):
    s = run.trace.seconds_where(is_l1) if run.trace else None
    return s * 1e3 / run.rec["steps"] if s and run.rec["steps"] else None
