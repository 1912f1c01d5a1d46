"""Device time of the kernels of the profiled predictions over their UNet
calls (ms a call; ``torch.profiler``, kernels that start inside a
``generate`` range)."""

from perfbench.timeline import within


def read(run):
    prof = run.profile
    if not prof:
        return None
    ks = within(prof["kernels"], prof["ranges"], "generate")
    n = sum(1 for s, _, _ in prof["ranges"] if s == "generate")
    if not ks or not n:
        return None
    return sum(b - a for _, a, b in ks) / 1e3 / (n * run.predictor.n_steps)
