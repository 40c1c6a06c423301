"""block_p99_ms: the 99th percentile over all blocks of the window (linear interpolation)
of a block's wall: due strikes and voice publish, render, host copy; host clock."""

import numpy as np


def read(run):
    walls = [u["wall"] for u in run.units]
    return float(np.percentile(walls, 99)) * 1e3 if walls else None
