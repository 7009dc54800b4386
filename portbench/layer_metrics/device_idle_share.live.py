"""The device's idle share of the traced window, in %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
