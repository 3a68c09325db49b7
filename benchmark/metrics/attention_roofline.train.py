"""% of their least time that the attention kernels take: each encoder
layer's forward and backward bounds (work/attention.py, from the
shapes) of the traced steps over the kernels' summed device time."""

from benchmark.kernels import is_attention
from benchmark.metrics_common import group_share


def read(run):
    return group_share(run, "attention", is_attention)
