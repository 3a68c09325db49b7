"""Device ms a step of kernels K5-K10 (K7/K8a/K8b among them; by name,
from the trace)."""

from benchmark.kernels import is_attention


def read(run):
    s = run.trace.seconds_where(is_attention) if run.trace else None
    return s * 1e3 / run.rec["steps"] if s and run.rec["steps"] else None
