"""tvc_torch — the PyTorch / CUDA port of ``tvc`` for NVIDIA Hopper.

A second package beside the JAX reference ``tvc``; module names mirror it
(``tvc_torch/core/config.py`` is the counterpart of ``tvc/core/config.py``,
and so on). It imports ``torch`` and never ``jax`` or ``tvc``.

This slice covers the predict-and-decide cycle: the NCSN++ UNet, the DDPM
sampler, the frame predictor, LPIPS(alex)/PSNR and the sender's accept
decision. The multi-head attention of every ``AttnBlockpp`` runs a CUDA
kernel written for ``sm_90a`` (``tvc_torch/csrc/attention.cu``).

Importing the package sets the numerics of ``tvc_torch.core.runtime``:
no TF32, deterministic cuDNN, no cuDNN benchmarking.
"""

from tvc_torch.core.runtime import set_numerics

set_numerics()
