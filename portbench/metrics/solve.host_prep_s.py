"""solve.host_prep_s: the mean over the window's solves of the host stages of
SolveProfile: mass properties, the quadratic mesh, the excitation points and the
extraction of the answer."""

FIELDS = ("mass_props", "quad_mesh", "sample_excite", "extract")


def read(run):
    if not run.units:
        return None
    return sum(sum(u[f] for f in FIELDS) for u in run.units) / len(run.units)
