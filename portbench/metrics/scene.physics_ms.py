"""scene.physics_ms: the physics steps of a scene block: the self time of the program's
`play/physics` span (one a PhysicsWorld.step), in ms per block over the recorded
`play/block` spans (mesheditor_tpu_torch.profile, which records spans while
`profile.enabled` is set or a torch.profiler records). None from a program without the span,
or where no `play/block` span was recorded."""


def read(run):
    from mesheditor_tpu_torch import profile

    spans = getattr(profile, "self_times", dict)()  # {} from a program without spans
    blocks = spans.get("play/block", (0, 0.0))[0]
    if "play/physics" not in spans or not blocks:
        return None
    return spans["play/physics"][1] * 1e3 / blocks
