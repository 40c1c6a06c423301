"""play.events_ms: the engine's strike drain: the impact table read to the host, mutated
there and uploaded. The self time of the program's `play/events` span, in ms per block over
the recorded `play/block` spans (mesheditor_tpu_torch.profile, which records spans while
`profile.enabled` is set or a torch.profiler records). None from a program without spans, or
where no `play/block` span was recorded."""


def read(run):
    from mesheditor_tpu_torch import profile

    spans = getattr(profile, "self_times", dict)()  # {} from a program without spans
    units = spans.get("play/block", (0, 0.0))[0]
    return spans.get("play/events", (0, 0.0))[1] * 1e3 / units if units else None
