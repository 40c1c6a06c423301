"""solve.amg_apply_s: the two-level AMG cycles applied inside the eigensolver's CG blocks.
The self time of the program's `solve/eigs/amg` span, in seconds per solve over the recorded
`solve/mesh2modes` spans (mesheditor_tpu_torch.profile, which records spans while
`profile.enabled` is set or a torch.profiler records). None from a program without spans, or
where no `solve/mesh2modes` span was recorded."""


def read(run):
    from mesheditor_tpu_torch import profile

    spans = getattr(profile, "self_times", dict)()  # {} from a program without spans
    units = spans.get("solve/mesh2modes", (0, 0.0))[0]
    return spans.get("solve/eigs/amg", (0, 0.0))[1] / units if units else None
