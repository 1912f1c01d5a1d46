"""tvc_torch — the PyTorch / CUDA port of ``tvc`` for NVIDIA Hopper.

A second package beside the JAX reference ``tvc``; module names mirror it
(``tvc_torch/core/config.py`` is the counterpart of ``tvc/core/config.py``,
and so on). It imports ``torch`` and never ``jax`` or ``tvc``.

It covers the main path: the ELIC keyframe codec with its rANS entropy
coders, the NCSN++ UNet, the DDPM sampler, the frame predictor,
LPIPS(alex)/PSNR, the sender's accept decision, the GOP loop, the receiver,
the serving runners and the rate sweep; and the evaluation path: FVD (I3D),
SSIM, the VGG/SqueezeNet LPIPS, FID/PR (InceptionV3) and the H.264/H.265
anchors. The command line is ``python -m tvc_torch.cli`` (``sweep``,
``codec``, ``gop``, ``anchors``). The
multi-head attention of every ``AttnBlockpp`` runs a CUDA kernel written for
``sm_90a`` (``tvc_torch/csrc/attention.cu``); the rANS coder is host C++.

Importing the package sets the numerics of ``tvc_torch.core.runtime``:
no TF32, deterministic cuDNN, no cuDNN benchmarking.
"""

from tvc_torch.core.runtime import set_numerics

set_numerics()
