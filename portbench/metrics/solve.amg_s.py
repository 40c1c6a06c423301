"""solve.amg_s: the mean over the window's solves of SolveProfile.factorize (the program's
own stage record; its device stages end in a synchronize)."""


def read(run):
    return sum(u["factorize"] for u in run.units) / len(run.units) if run.units else None
