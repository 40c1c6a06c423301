"""impact_roofline: the traced blocks' bound time (portbench/roofline.py, counted from the
workload, voice-free) over the device time of the impact resonator kernel and its mix
sum, in %."""

from portbench.roofline import roofline_percent

KERNELS = ("resonate_kernel", "mix_kernel")


def read(run):
    return roofline_percent(run.trace, KERNELS)
