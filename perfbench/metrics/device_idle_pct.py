"""Share of the profiled interval in which no kernel, copy or set runs on
the card (%; the union of the profiler's device intervals)."""


def read(run):
    prof = run.profile
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
