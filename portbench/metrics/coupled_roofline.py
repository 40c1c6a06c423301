"""coupled_roofline: the traced blocks' bound time (portbench/roofline.py, counted from the
workload) over the device time of the coupled resonator kernel and its mix sum, in %."""

from portbench.roofline import roofline_percent

KERNELS = ("coupled_", "mix_kernel")


def read(run):
    return roofline_percent(run.trace, KERNELS)
