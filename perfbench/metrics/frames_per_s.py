"""Frames of the GOPs completed in the window over the window's length."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 and run.frames else None
