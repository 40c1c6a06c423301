"""setup_s: seconds from the process's start to the window's (imports, builds, the
cell's inputs and its warm-up calls); host clock."""


def read(run):
    return run.setup_s
