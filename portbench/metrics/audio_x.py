"""audio_x: seconds of audio delivered per wall second over the whole window."""


def read(run):
    play = run.config["play"]
    return len(run.units) * play["block"] / play["sample_rate"] / run.window_s
