"""The attention kernels' share of their roofline in the profiled interval
(%): the least time the chip needs for their launches (per launch the
larger of operations over the dtype's peak and bytes over the memory's
rate, ``perfbench/flops.py``; the launches of a UNet call are the
configuration's reference module's ``attention_launches``) over the
kernels' device time."""

from perfbench.flops import unet_attention_bound_s

# the port's attention kernels, by the names the profiler gives them
KERNELS = ("attention_fwd", "attention_tc")
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def read(run):
    prof, peaks = run.profile, run.peaks
    if not prof or not peaks:
        return None
    ks = [k for k in prof["kernels"] if any(n in k[0] for n in KERNELS)]
    cfg, dtype = run.config["config"], run.config["dtype"]
    launches = run.reference.attention_launches(cfg)
    if not ks or not launches:
        return None
    calls = len(ks) / len(launches)
    bound = calls * unet_attention_bound_s(launches, run.batch, ITEMSIZE[dtype], peaks[dtype],
                                           peaks["hbm_bytes_s"])
    return 100.0 * bound / (sum(b - a for _, a, b in ks) / 1e6)
