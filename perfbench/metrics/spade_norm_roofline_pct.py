"""The SPADE norm kernel's share of its roofline in the profiled interval (%):
the least time the chip needs for its launches over their device time.

A UNet call of a SPADE configuration runs one modulated norm for each of its
reference module's ``spade_norm_launches`` ((C, H, W) of each, in order).
Such a norm does a few operations a byte, far below the ridge, so its least
time is its bytes at the memory's rate: x, gamma and beta read once and y
written once, each (batch, C, H, W) in the configuration's dtype. The (N, C)
scale and shift of the time embedding are left out (a few KB against MB).
The kernel's launches are those whose name holds ``spade``; calls =
launches / norms a call. Reads nothing where no such kernel ran, or where the
configuration's reference lists no modulated norms.
"""

KERNEL = "spade"
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound_s(launches, batch: int, itemsize: int, peak_bytes_s: float) -> float:
    """The least time of one call's modulated norms: four tensors of each
    norm's size moved at ``peak_bytes_s``."""
    return sum(4.0 * batch * c * h * w * itemsize for c, h, w in launches) / peak_bytes_s


def read(run):
    prof, peaks = run.profile, run.peaks
    norms = getattr(run.reference, "spade_norm_launches", None)
    if not prof or not peaks or norms is None:
        return None
    launches = norms(run.config["config"])
    ks = [k for k in prof["kernels"] if KERNEL in k[0]]
    if not ks or not launches:
        return None
    calls = len(ks) / len(launches)
    bound = calls * bound_s(launches, run.batch, ITEMSIZE[run.config["dtype"]],
                            peaks["hbm_bytes_s"])
    return 100.0 * bound / (sum(b - a for _, a, b in ks) / 1e6)
