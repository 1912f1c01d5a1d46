"""Device selection and the numerics every run of the port uses.

Entry points take an explicit ``device``, ``"cuda"`` by default. A default
call on a host without a card raises; nothing drops silently to the CPU.

On the card, the f32 path is full f32 and repeatable: TF32 is off for
convolutions and matrix products, and cuDNN picks its algorithms
deterministically, without benchmarking. The receiver regenerates frames by
rerunning the sender's prediction, so the same prediction twice must be
bit-identical.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def set_numerics() -> Dict[str, bool]:
    """Set (and return) the backend flags the port's numerics rely on."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return numerics()


def numerics() -> Dict[str, bool]:
    """The backend flags as they stand now."""
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.benchmark": torch.backends.cudnn.benchmark,
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
    }


def to_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """A numpy array (copied) or tensor as ``dtype`` on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the host")
    return dev
