"""idle.solve: the device's idle share of the traced stretch of the window, in %: one minus
the union of its operations' intervals over the host wall (torch.profiler)."""


def read(run):
    return 100.0 * run.trace.idle_share if run.trace is not None else None
