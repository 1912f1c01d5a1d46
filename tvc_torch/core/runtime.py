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


def numerics_stamp(device, entropy_backend: str) -> Dict[str, str]:
    """What decides a run's bits, as strings: the versions of torch, CUDA and
    cuDNN, the card, the backend flags, the codec's entropy backend and the
    attention kernel's build key; where the host computes something the
    receiver must repeat, its CPU's vector capability, and on a CPU device
    its thread count. A GOP payload carries it, and a receiver whose own
    stamp differs refuses the payload."""
    from tvc_torch.ops import _build

    dev = resolve_device(device)
    stamp = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "cudnn": str(torch.backends.cudnn.version()),
        "device": dev.type,
        "gpu": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "none",
        "entropy_backend": entropy_backend,
        "attention_build": _build.build_key("attention"),
    }
    stamp.update({k: str(v) for k, v in numerics().items()})
    if dev.type == "cpu" or entropy_backend == "cpu":
        stamp["cpu_capability"] = torch.backends.cpu.get_cpu_capability()
    if dev.type == "cpu":
        stamp["cpu_threads"] = str(torch.get_num_threads())
    return stamp


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
