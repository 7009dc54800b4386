"""K3 (`csrc/wire_unpack.cu`, both launches): the least time of its calls
over its device time, in %."""

from portbench.readers import roofline


def read(run):
    return roofline(run, 'k3')
