"""Mean wall time of one prediction (``FramePredictor.generate``: every UNet
call of an update at the cell's batch), ending in a synchronize (s)."""

from perfbench.timeline import host_spans as in_window


def read(run):
    spans = in_window(run, "generate") if run.trace else []
    return sum(b - a for a, b in spans) / len(spans) if spans else None
