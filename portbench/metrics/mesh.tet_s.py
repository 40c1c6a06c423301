"""mesh.tet_s: the mean wall of the program's `solve/tetrahedralize` scope over the
window's solves (the scopes are on in the traced run only)."""


def read(run):
    count, total = run.counters.get("scopes", {}).get("solve/tetrahedralize", (0, 0.0))
    return total / count if count else None
