"""scene.bridge_ms: the contact bridge of a scene block (impact reports into strikes, the
sustained contacts into the block's voice set): the self time of the program's `play/bridge`
span, in ms per block over the recorded `play/block` spans (mesheditor_tpu_torch.profile,
which records spans while `profile.enabled` is set or a torch.profiler records). None from a
program without the span, or where no `play/block` span was recorded."""


def read(run):
    from mesheditor_tpu_torch import profile

    spans = getattr(profile, "self_times", dict)()  # {} from a program without spans
    blocks = spans.get("play/block", (0, 0.0))[0]
    if "play/bridge" not in spans or not blocks:
        return None
    return spans["play/bridge"][1] * 1e3 / blocks
