"""play.reads: the engine's reads of the device, per block: the program's `play/reads`
counter (one a field each play table's `to_numpy` reads) over its recorded `play/block` spans
(mesheditor_tpu_torch.profile, which counts while `profile.enabled` is set or a
torch.profiler records). None from a program without the counter, or where no `play/block`
span was recorded."""


def read(run):
    from mesheditor_tpu_torch import profile

    spans = getattr(profile, "self_times", dict)()  # {} from a program without spans
    blocks = spans.get("play/block", (0, 0.0))[0]
    return profile.counts().get("play/reads", 0) / blocks if blocks else None
