"""play.resonate_ms: the resonator kernel's call on the host: bind and launch. The self time
of the program's `play/resonate` span, in ms per block over the recorded `play/block` spans
(mesheditor_tpu_torch.profile, which records spans while `profile.enabled` is set or a
torch.profiler records). None from a program without spans, or where no `play/block` span
was recorded."""


def read(run):
    from mesheditor_tpu_torch import profile

    spans = getattr(profile, "self_times", dict)()  # {} from a program without spans
    units = spans.get("play/block", (0, 0.0))[0]
    return spans.get("play/resonate", (0, 0.0))[1] * 1e3 / units if units else None
