"""Kernel launches (the program's exact counter, `ops.kernels.launches`)
over the window, per frame delivered in it."""

from portbench.readers import launches_per_frame


def read(run):
    return launches_per_frame(run)
