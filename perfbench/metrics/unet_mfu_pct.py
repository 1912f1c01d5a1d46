"""The UNet's operations in the traced window, over the window, over the
card's peak at the configuration's compute dtype (%): the whole step's
share of the peak. Operations: the configuration's reference module's
``unet_flops``, by ``perfbench/flops.py``'s rules."""


def read(run):
    peaks = run.peaks
    if not run.trace or not peaks or run.traced_window_s <= 0 or not run.unet_calls:
        return None
    ops = run.reference.unet_flops(run.config["config"], run.batch) * run.unet_calls
    return 100.0 * ops / run.traced_window_s / peaks[run.config["dtype"]]
