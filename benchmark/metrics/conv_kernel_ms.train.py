"""Device ms a step of cuDNN's convolution kernels (the FCN expert's; by
name, from the trace)."""

from benchmark.kernels import is_conv


def read(run):
    s = run.trace.seconds_where(is_conv) if run.trace else None
    return s * 1e3 / run.rec["steps"] if s and run.rec["steps"] else None
