"""Published peaks of the chips the benchmark runs on (dense rates, no sparsity).

NVIDIA H100 SXM data sheet, at its full 700 W: 67 TFLOP/s in float32 on the
CUDA cores, 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3. A
card set to a lower power limit runs slower under load; the run reports the
limit beside every share of a peak.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": {"float32": 67e12, "bfloat16": 989e12, "hbm_bytes_s": 3.35e12},
}


def peaks_for(device_kind: str) -> Optional[dict]:
    for key, table in PEAKS.items():
        if key in device_kind:
            return table
    return None
