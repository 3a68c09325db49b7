"""% of their least time that K1-K4 take: the banks' forward and
backward bounds (work/l1.py, from the shapes) of the traced steps over
the kernels' summed device time."""

from benchmark.kernels import is_l1
from benchmark.metrics_common import group_share


def read(run):
    return group_share(run, "l1", is_l1)
