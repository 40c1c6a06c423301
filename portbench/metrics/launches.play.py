"""launches.play: device operations (kernels, copies, sets) a block over the traced
blocks (torch.profiler)."""


def read(run):
    t = run.trace
    return t.op_count / t.units if t is not None and t.units else None
