"""% of their least time that the FCN's convolution kernels take: the
convolutions' forward and backward bounds (work/interpgn.py, from the
shapes) of the traced steps over the kernels' summed device time."""

from benchmark.kernels import is_conv
from benchmark.metrics_common import group_share


def read(run):
    return group_share(run, "conv", is_conv)
