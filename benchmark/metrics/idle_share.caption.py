"""The device's idle share of the traced window, %: 1 - busy / window,
busy being the union of every kernel's and copy's interval."""

from benchmark.metrics_common import idle_share


def read(ctx):
    return idle_share(ctx)
