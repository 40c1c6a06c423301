"""solve_s: the window's seconds over the solves completed in it; host clock. A solve is
one whole user call, mesh or surface in, host arrays out."""


def read(run):
    return run.window_s / len(run.units) if run.units else None
