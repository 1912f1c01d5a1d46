"""Seeded random weights, made on the device in one draw per network.

No checkpoint is in the repository, so every network runs on weights drawn
from the run's seed. One ``torch.Generator`` on the device draws one
standard-normal vector for a whole network; each weight takes its slice,
scaled by a rule of its kind, in its stored dtype. The benchmark keeps the
tensors it filled and hands the same ones to the program and to the
reference.

Scales keep a signal's size through the network, so that the prediction,
the scores and the codes are not degenerate (equal weights everywhere would
make every channel alike and the comparison blind):

- a convolution or dense weight: N(0, 1 / fan_in), fan_in the product of the
  weight's dimensions past the first (of a transposed convolution's, as the
  LeCun init of the JAX package counts it too);
- an NCSN++ ``NIN`` weight (in, out): N(0, 1 / in);
- a GroupNorm scale 1 + N(0, 0.1^2), its shift N(0, 0.1^2);
- a bias of the UNet N(0, 0.02^2); the codec's and the LPIPS trunk's biases 0;
- the LPIPS heads 0.1;
- the codec's factorized prior as compressai initializes it, with its
  biases from the same generator: constant matrices
  log(expm1(1 / scale / f)), f the rows of each matrix and scale
  10^(1 / matrices), biases U(-0.5, 0.5), zero factors, quantiles
  (-10, 0, 10).
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Iterable, List, Tuple

import torch
from torch import nn


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's ``seed``."""
    text = "/".join([str(seed), *map(str, tags)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def _fill(pairs: List[Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]],
          generator: torch.Generator) -> None:
    total = sum(t.numel() for t, _ in pairs)
    z = torch.randn(total, generator=generator, device=generator.device, dtype=torch.float32)
    off = 0
    with torch.no_grad():
        for t, rule in pairs:
            n = t.numel()
            t.copy_(rule(z[off: off + n].view(t.shape)))
            off += n


def _fan_in(t: torch.Tensor) -> int:
    return max(t[0].numel(), 1)


def unet_rule(name: str, t: torch.Tensor):
    if name.endswith(("GroupNorm_0.weight", "Norm_0.weight")):
        return lambda z: 1.0 + 0.1 * z
    if name.endswith(("GroupNorm_0.bias", "Norm_0.bias")):
        return lambda z: 0.1 * z
    if name.endswith((".bias", ".b")):
        return lambda z: 0.02 * z
    if name.endswith(".W"):  # NIN: (in, out)
        return lambda z, s=1.0 / math.sqrt(t.shape[0]): z * s
    return lambda z, s=1.0 / math.sqrt(_fan_in(t)): z * s


def fill_unet_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every floating weight of an NCSN++ ``UNetMoreDDPM``."""
    pairs = [(t, unet_rule(n, t)) for n, t in model.state_dict(keep_vars=True).items()
             if t.is_floating_point()]
    _fill(pairs, generator)
    return model


def _convs(module: nn.Module) -> Iterable[nn.Module]:
    return [m for m in module.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]


def fill_convs_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """LeCun-normal convolution weights, zero biases."""
    pairs = []
    for m in _convs(module):
        pairs.append((m.weight, lambda z, s=1.0 / math.sqrt(_fan_in(m.weight)): z * s))
        if m.bias is not None:
            pairs.append((m.bias, lambda z: z * 0.0))
    _fill(pairs, generator)
    return module


PRIOR = "entropy_bottleneck."
PRIOR_INIT_SCALE = 10.0


def fill_prior_(state: dict, generator: torch.Generator) -> None:
    """The factorized prior's tensors of an ELIC state dict, by their names."""
    prior = {k[len(PRIOR):]: t for k, t in state.items() if k.startswith(PRIOR)}
    matrices = [k for k in prior if k.startswith("_matrices.")]
    scale = PRIOR_INIT_SCALE ** (1.0 / len(matrices))
    biases = [prior[k] for k in sorted(prior) if k.startswith("_biases.")]
    u = torch.rand(sum(b.numel() for b in biases), generator=generator,
                   device=generator.device, dtype=torch.float32)
    off = 0
    with torch.no_grad():
        for k in matrices:
            prior[k].fill_(math.log(math.expm1(1.0 / scale / prior[k].shape[1])))
        for b in biases:
            b.copy_(u[off: off + b.numel()].view(b.shape) - 0.5)
            off += b.numel()
        for k in prior:
            if k.startswith("_factors."):
                prior[k].zero_()
        q = prior["quantiles"]
        q.copy_(torch.tensor([-PRIOR_INIT_SCALE, 0.0, PRIOR_INIT_SCALE], device=q.device)
                .expand_as(q))


def fill_elic_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    fill_convs_(model, generator)
    fill_prior_(model.state_dict(keep_vars=True), generator)
    return model


def fill_lpips_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    fill_convs_(model.net, generator)
    with torch.no_grad():
        for k in range(len(model.taps)):
            getattr(model, f"lin{k}").fill_(0.1)
    return model
