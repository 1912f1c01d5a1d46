"""Device selection and the numerics every run of the port uses.

Entry points take an explicit ``device``, ``"cuda"`` by default. A default
call on a host without a card raises; nothing drops silently to the CPU.

On the card, the f32 path is full f32 and repeatable: TF32 is off for
convolutions and matrix products, and cuDNN picks its algorithms
deterministically, without benchmarking. The receiver regenerates frames by
rerunning the sender's prediction, so the same prediction twice must be
bit-identical. A bfloat16 matrix product accumulates in float32, as XLA
accumulates the JAX package's bf16 einsums: cuBLAS may not reduce in bf16.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch


def set_numerics() -> Dict[str, bool]:
    """Set (and return) the backend flags the port's numerics rely on."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return numerics()


def numerics() -> Dict[str, bool]:
    """The backend flags as they stand now."""
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.benchmark": torch.backends.cudnn.benchmark,
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "cuda.matmul.allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    }


# the sampler settings that change a prediction's frames
SAMPLER_FIELDS = ("model.version", "model.gamma", "sampling.init_prev_t", "sampling.subsample",
                  "sampling.denoise", "sampling.clip_before")


def numerics_stamp(device, cfg, compute_dtype=torch.float32) -> Dict[str, str]:
    """What decides a run's bits, as strings: the versions of torch, CUDA and
    cuDNN, the card, the backend flags, the codec's entropy backend, the
    attention kernel's build key, the sampler's settings of ``cfg``, the
    predictor's ``compute_dtype``, its ``sampling.precision_schedule`` and
    ``TVC_GN_BF16_IO`` (the JAX package stamps ``env_gn_bf16_io``);
    where the host computes something the receiver must repeat, its CPU's
    vector capability, and on a CPU device its thread count. A GOP payload
    carries it, and a receiver whose own stamp differs refuses the payload."""
    from tvc_torch.models.diffusion.layers import gn_bf16_io
    from tvc_torch.ops import _build

    dev = resolve_device(device)
    entropy_backend = cfg.codec.entropy_backend
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
    stamp["compute_dtype"] = str(compute_dtype).replace("torch.", "")
    stamp["sampling.precision_schedule"] = cfg.sampling.precision_schedule
    stamp["env_gn_bf16_io"] = str(int(gn_bf16_io()))
    for field in SAMPLER_FIELDS:
        section, key = field.split(".")
        value = getattr(getattr(cfg, section), key)
        stamp[field] = value.upper() if field == "model.version" else str(value)
    if dev.type == "cpu" or entropy_backend == "cpu":
        stamp["cpu_capability"] = torch.backends.cpu.get_cpu_capability()
    if dev.type == "cpu":
        stamp["cpu_threads"] = str(torch.get_num_threads())
    return stamp


@contextlib.contextmanager
def batched_conv_algorithms(batch: int, device):
    """Let cuDNN time its deterministic algorithms, float32 without TF32, for
    a batch of more than one on the card; a batch of one keeps its heuristic
    choice.

    On the H100 the heuristic picks an FFT algorithm for some of the UNet's
    convolutions at B = 2 and 4 that makes a call 4.1-4.8 s long against
    67-75 ms after timing (``python -m tvc_torch.tools.conv_algorithms``).
    Only the in-process batched paths (the lockstep runner, the whole-GOP
    sender's ``run_batched``) predict at B > 1, and no receiver repeats their
    frames; training, which writes no bitstream, enters it at its
    per-process batch. cuDNN caches its choice per shape
    for the process, so a rerun is bit-identical; another process may choose
    another algorithm where two are about as fast. B = 1, which a receiver
    repeats, is untouched: the choice is keyed by the batch size."""
    if batch == 1 or torch.device(device).type != "cuda":
        yield
        return
    with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=True,
                                    allow_tf32=False):
        yield


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
