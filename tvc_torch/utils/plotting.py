"""RD plots against H.264/H.265 anchor curves (counterpart of ``tvc/utils/plotting.py``).

Three line charts (PSNR, LPIPS, FVD against bpp) of the neural envelope over
anchor arrays of shape (videos, 4 metrics [psnr, lpips, fvd, bpp], QPs),
their bpp kept within [0, 1.2]. matplotlib is imported when a plot is drawn,
so a host without it can run everything else.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _plot_line(ax, x_new, y_new, x_264, y_264, x_265, y_265, x_label, y_label, title):
    ax.plot(x_new, y_new, label="Neural Network", color="red", marker="o", linestyle="-")
    if x_264 is not None:
        ax.plot(x_264, y_264, label="H.264", color="blue", marker="o", linestyle="-")
    if x_265 is not None:
        ax.plot(x_265, y_265, label="H.265", color="orange", marker="o", linestyle="-")
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    ax.set_title(title)
    ax.legend()


def _valid(anchor_row):
    bpp = anchor_row[3]
    idx = np.where((bpp >= 0) & (bpp <= 1.2))[0]
    return bpp[idx], anchor_row[0][idx], anchor_row[1][idx], anchor_row[2][idx]


def plot(databatchidx: int, psnr_arr: np.ndarray, lpips_arr: np.ndarray, fvd_arr: np.ndarray,
         output_path: str, bench_264: Optional[str] = None,
         bench_265: Optional[str] = None) -> None:
    """psnr/lpips/fvd arrays are (2, K) [bpp; metric] envelopes; the anchor
    files (``bench_264``/``bench_265``) are left out where they do not exist.
    Raises ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a264 = a265 = None
    if bench_264 and os.path.exists(bench_264):
        a264 = _valid(np.load(bench_264)[databatchidx])
    if bench_265 and os.path.exists(bench_265):
        a265 = _valid(np.load(bench_265)[databatchidx])

    os.makedirs(output_path, exist_ok=True)
    for name, arr, row in (("PSNR", psnr_arr, 1), ("LPIPS", lpips_arr, 2), ("FVD", fvd_arr, 3)):
        fig, ax = plt.subplots()
        x4 = y4 = x5 = y5 = None
        # an anchor tuple from _valid is (bpp, psnr, lpips, fvd)
        if a264 is not None:
            x4, y4 = a264[0], a264[row]
        if a265 is not None:
            x5, y5 = a265[0], a265[row]
        _plot_line(ax, arr[0, :], arr[1, :], x4, y4, x5, y5, "BPP", name,
                   f"BPP_{name}_idx{databatchidx}")
        fig.savefig(os.path.join(output_path, f"BPP_{name}_idx{databatchidx}.png"))
        plt.close(fig)
