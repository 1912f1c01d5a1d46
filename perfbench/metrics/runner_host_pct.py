"""Share of the traced window outside the predictor's and the keyframe
coder's synchronized spans: the GOP runner's own host work, its scoring,
fetches and payloads (%)."""

from perfbench.timeline import host_seconds as seconds


def read(run):
    if not run.trace or run.traced_window_s <= 0:
        return None
    inside = seconds(run, "generate") + seconds(run, "keyframe")
    return 100.0 * (1.0 - inside / run.traced_window_s)
