"""K1 (`csrc/dequant_idct.cu`): the least time of its launches over its
device time, in %."""

from portbench.readers import roofline


def read(run):
    return roofline(run, 'k1')
