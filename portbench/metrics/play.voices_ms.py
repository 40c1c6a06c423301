"""play.voices_ms: the engine's voice publish: the reconcile into the host mirror and its
packed upload. The self time of the program's `play/voices` span, in ms per block over the
recorded `play/block` spans (mesheditor_tpu_torch.profile, which records spans while
`profile.enabled` is set or a torch.profiler records). None from a program without spans, or
where no `play/block` span was recorded, or where no voice was ever published (no
`play/voices` span)."""


def read(run):
    from mesheditor_tpu_torch import profile

    spans = getattr(profile, "self_times", dict)()  # {} from a program without spans
    units = spans.get("play/block", (0, 0.0))[0]
    if "play/voices" not in spans:
        return None
    return spans["play/voices"][1] * 1e3 / units if units else None
