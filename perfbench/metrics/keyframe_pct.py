"""Share of the traced window inside the keyframe coder's spans (%)."""

from perfbench.timeline import host_seconds as seconds


def read(run):
    if not run.trace or run.traced_window_s <= 0:
        return None
    kf = seconds(run, "keyframe")
    return 100.0 * kf / run.traced_window_s if kf > 0 else None
