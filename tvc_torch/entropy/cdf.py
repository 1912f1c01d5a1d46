"""PMF -> quantized CDF conversion (16-bit), compressai/ryg_rans-compatible
(counterpart of ``tvc/entropy/cdf.py``; the same tables).

Implements the standard stb/ryg_rans normalization used by the reference's
entropy coder: round probabilities to a 2^16 grid, rescale to sum exactly to
2^16, then repair zero-frequency bins in order, each stealing one count from
the lowest-frequency bin > 1 (the first such bin on a tie). Pure numpy,
float64, host-side. The repair keeps the candidate bins in a heap, so a table
with thousands of empty tail bins (the Gaussian coder's widest scales) takes
milliseconds rather than the seconds of a scan per empty bin.
"""

from __future__ import annotations

import heapq

import numpy as np

PRECISION = 16


def pmf_to_quantized_cdf(pmf: np.ndarray, precision: int = PRECISION) -> np.ndarray:
    """Quantize a pmf (including the tail-mass bin as its last entry) to a CDF.

    Returns int32 array of length len(pmf)+1 with cdf[0]=0, cdf[-1]=2^precision,
    and every bin non-empty.
    """
    pmf = np.asarray(pmf, dtype=np.float64)
    if np.any(pmf < 0) or not np.all(np.isfinite(pmf)):
        raise ValueError("invalid pmf")
    n = len(pmf)
    cdf = np.zeros(n + 1, dtype=np.int64)
    cdf[1:] = np.round(pmf * (1 << precision)).astype(np.int64)

    total = int(cdf.sum())
    if total == 0:
        raise ValueError("pmf is all-zero")
    # rescale so the running sum hits exactly 2^precision
    cdf = ((1 << precision) * cdf) // total
    cdf = np.cumsum(cdf)
    cdf[-1] = 1 << precision

    # repair empty bins. A repair moves one count from the bin it steals
    # from to the empty bin, so the empty bins are the initial zeros and a
    # bin above 1 stays above 0: (frequency, index) in a heap, with stale
    # entries dropped as they surface, gives each repair's bin
    freq = np.diff(cdf)
    empty = np.flatnonzero(freq == 0)
    if empty.size:
        heap = [(int(f), j) for j, f in enumerate(freq.tolist()) if f > 1]
        heapq.heapify(heap)
        for i in empty:
            while heap and freq[heap[0][1]] != heap[0][0]:
                heapq.heappop(heap)
            if not heap:
                raise ValueError("cannot repair cdf: no bin to steal from")
            f, j = heapq.heappop(heap)
            freq[j] -= 1
            freq[i] = 1
            if f - 1 > 1:
                heapq.heappush(heap, (f - 1, j))
        cdf = np.concatenate([[0], np.cumsum(freq)])

    assert cdf[0] == 0 and cdf[-1] == (1 << precision)
    assert np.all(np.diff(cdf) > 0)
    return cdf.astype(np.int32)


def build_cdf_table(pmfs: np.ndarray, tail_mass: np.ndarray, pmf_lengths: np.ndarray,
                    max_length: int) -> np.ndarray:
    """Stack per-channel/per-scale CDFs into a padded int32 matrix.

    Row i holds the quantized CDF of `pmfs[i, :pmf_lengths[i]]` with the tail
    mass appended as the escape bin; padded with zeros to max_length + 2.
    """
    n = pmfs.shape[0]
    out = np.zeros((n, max_length + 2), dtype=np.int32)
    for i in range(n):
        p = np.concatenate([pmfs[i, : pmf_lengths[i]], [tail_mass[i]]])
        c = pmf_to_quantized_cdf(p)
        out[i, : len(c)] = c
    return out
