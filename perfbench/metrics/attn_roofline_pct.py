"""The attention kernels' share of their roofline in the profiled interval
(%): the least time the chip needs for their launches (per launch the
larger of operations over the dtype's peak and bytes over the memory's
rate, ``perfbench/flops.py``) over the kernels' device time."""

from perfbench.flops import attention_launches, unet_attention_bound_s

# the port's attention kernels, by the names the profiler gives them
KERNELS = ("attention_fwd", "attention_tc")
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def read(run):
    prof, peaks = run.profile, run.peaks
    if not prof or not peaks:
        return None
    ks = [k for k in prof["kernels"] if any(n in k[0] for n in KERNELS)]
    if not ks:
        return None
    cfg, dtype = run.config["config"], run.config["dtype"]
    calls = len(ks) / len(attention_launches(cfg))
    bound = calls * unet_attention_bound_s(cfg, run.batch, ITEMSIZE[dtype], peaks[dtype],
                                           peaks["hbm_bytes_s"])
    return 100.0 * bound / (sum(b - a for _, a, b in ks) / 1e6)
