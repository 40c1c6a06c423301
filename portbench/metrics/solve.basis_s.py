"""solve.basis_s: the eigensolver's basis work: Ritz vectors, the W and P products and
projections, Cholesky-QR and the Rayleigh-Ritz eigh. The self time of the program's
`solve/eigs/basis` span, in seconds per solve over the recorded `solve/mesh2modes` spans
(mesheditor_tpu_torch.profile, which records spans while `profile.enabled` is set or a
torch.profiler records). None from a program without spans, or where no `solve/mesh2modes`
span was recorded."""


def read(run):
    from mesheditor_tpu_torch import profile

    spans = getattr(profile, "self_times", dict)()  # {} from a program without spans
    units = spans.get("solve/mesh2modes", (0, 0.0))[0]
    return spans.get("solve/eigs/basis", (0, 0.0))[1] / units if units else None
