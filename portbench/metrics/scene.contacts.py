"""scene.contacts: contact points the physics step solves, per step: the program's
`physics/contacts` counter over its `physics/steps` counter (mesheditor_tpu_torch.profile,
which counts while `profile.enabled` is set or a torch.profiler records). None from a program
without the counters, or where no step was counted."""


def read(run):
    from mesheditor_tpu_torch import profile

    counts = getattr(profile, "counts", dict)()  # {} from a program without counters
    steps = counts.get("physics/steps", 0)
    return counts.get("physics/contacts", 0) / steps if steps else None
