"""% of the traced window in which the card ran no kernel or copy (the
union of the device intervals)."""

from benchmark.metrics_common import idle_share


def read(run):
    return idle_share(run)
