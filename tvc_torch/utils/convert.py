"""Carry weights into the port: JAX parameter trees and reference checkpoints.

A JAX (Flax) parameter tree, given as nested dicts of numpy arrays, maps onto
the port's state dict by name:

  ``m{i}``               -> ``all_modules.{i}`` (the reference's module index)
  ``conv`` / ``gn``      -> dropped (the JAX wrapper modules around nn.Conv / nn.GroupNorm)
  ``kernel`` (kh,kw,I,O) -> ``weight`` (O,I,kh,kw)
  ``kernel`` (in,out)    -> ``weight`` (out,in)
  ``scale``, ``embedding`` -> ``weight``
  anything else (``bias``, NIN ``W``/``b``, ``W``) keeps its name and layout.

The port's UNet names its parameters with the reference's ``all_modules``
keys, so a reference ``checkpoint_*.pt`` loads with ``load_diffusion_checkpoint``
and no conversion of layouts. The ELIC codec likewise: ``elic_from_jax`` maps
a JAX ``ELICModel`` tree onto the reference's keys, and
``load_codec_checkpoint`` reads a reference ``*.pth.tar``. The evaluation
networks name theirs after pytorch_i3d's and torchvision's keys:
``i3d_from_jax``, ``inception_from_jax``, ``vgg16_from_jax`` and
``squeezenet_from_jax`` map the JAX trees onto them.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from tvc_torch.core.config import Config

_DROPPED = ("conv", "gn")
_RENAMED = {"scale": "weight", "embedding": "weight"}


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def _leaf(name: str, a) -> tuple:
    t = _tensor(a)
    if name == "kernel":
        return "weight", t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
    return _RENAMED.get(name, name), t


def state_dict_from_jax(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a JAX parameter (sub)tree into port state-dict entries.
    Tensors may be views of the numpy arrays; ``load_state_dict`` copies them."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            if name in _DROPPED:
                key = prefix
            elif name[0] == "m" and name[1:].isdigit():
                key = f"{prefix}all_modules.{name[1:]}."
            else:
                key = f"{prefix}{name}."
            out.update(state_dict_from_jax(v, key))
        else:
            leaf, t = _leaf(name, v)
            out[prefix + leaf] = t
    return out


def unet_from_jax(cfg: Config, np_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{'params': {'unet': {'m{i}': ...}}}`` (the JAX ``UNetMoreDDPM``
    variables) -> the port's ``UNetMoreDDPM`` state dict (``unet.all_modules.{i}.*``)."""
    if cfg.model.spade or cfg.model.arch in ("unetmore3d", "unetmorepseudo3d"):
        raise NotImplementedError("only the 2-D NCSN++ UNet is ported (3-D archs: ROADMAP.md A12)")
    return state_dict_from_jax(np_params["params"]["unet"], "unet.")


def lpips_from_jax(np_params: Dict[str, Any], net_type: str = "alex") -> Dict[str, torch.Tensor]:
    """The JAX LPIPS ``params`` tree (``net/...``, ``lin{k}`` as (1, 1, C, 1))
    -> the port's ``LPIPS`` state dict (``lin{k}`` as (1, C, 1, 1)); the
    backbone's keys as ``net_type`` (alex | vgg | squeeze) names them."""
    params = np_params.get("params", np_params)
    if net_type == "alex":
        out = state_dict_from_jax({"net": params["net"]})
    else:
        backbone = {"vgg": vgg16_from_jax, "squeeze": squeezenet_from_jax}[net_type]
        out = {f"net.{k}": v for k, v in backbone(params["net"]).items()}
    for k, v in params.items():
        if k.startswith("lin"):
            out[k] = _tensor(v).permute(3, 2, 0, 1)
    return out


# ---------------------------------------------------------------------------
# Evaluation networks: flax conv kernels are (k..., in, out), torch's (out, in, k...)
# ---------------------------------------------------------------------------


def _conv(prefix: str, tree: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    k = np.asarray(tree["kernel"])
    out[f"{prefix}.weight"] = _tensor(np.ascontiguousarray(
        np.moveaxis(k, (-1, -2), (0, 1))))
    if "bias" in tree:
        out[f"{prefix}.bias"] = _tensor(tree["bias"])


def _bn(prefix: str, tree: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    for jax_name, name in (("bn_scale", "weight"), ("bn_bias", "bias"),
                           ("bn_mean", "running_mean"), ("bn_var", "running_var")):
        out[f"{prefix}.{name}"] = _tensor(tree[jax_name])


def i3d_from_jax(np_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``InceptionI3d`` tree (``Unit3D``: ``conv3d/kernel`` (kt, kh, kw,
    in, out), ``bn_scale``/``bn_bias``/``bn_mean``/``bn_var``) -> the port's
    ``InceptionI3d`` state dict in pytorch_i3d's keys."""
    params = np_params.get("params", np_params)
    out: Dict[str, torch.Tensor] = {}

    def unit(prefix, tree):
        _conv(f"{prefix}.conv3d", tree["conv3d"], out)
        if "bn_scale" in tree:
            _bn(f"{prefix}.bn", tree, out)

    for name, tree in params.items():
        if name.startswith("Mixed"):
            for branch, sub in tree.items():
                unit(f"{name}.{branch}", sub)
        else:
            unit(name, tree)
    return out


def inception_from_jax(np_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``InceptionV3Features`` tree -> the port's state dict in
    torchvision's ``inception_v3`` keys (``BasicConv2d``: ``conv``, ``bn``)."""
    params = np_params.get("params", np_params)
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix, tree):
        if "conv" in tree:  # a BasicConv2d
            _conv(f"{prefix}.conv", tree["conv"], out)
            _bn(f"{prefix}.bn", tree, out)
            return
        for name, sub in tree.items():
            walk(f"{prefix}.{name}" if prefix else name, sub)

    walk("", params)
    return out


def vgg16_from_jax(np_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``VGG16Features`` tree (``conv{i}``) -> torchvision ``vgg16``
    ``features.{i}`` keys."""
    from tvc_torch.metrics.backbones import VGG_CONV_IDS

    params = np_params.get("params", np_params)
    out: Dict[str, torch.Tensor] = {}
    for i, cid in enumerate(VGG_CONV_IDS):
        _conv(f"features.{cid}", params[f"conv{i}"], out)
    return out


def squeezenet_from_jax(np_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``SqueezeNetFeatures`` tree (``conv0``, ``fire{i}``) ->
    torchvision ``squeezenet1_1`` ``features.{i}`` keys."""
    from tvc_torch.metrics.backbones import SQUEEZE_FIRE

    params = np_params.get("params", np_params)
    out: Dict[str, torch.Tensor] = {}
    _conv("features.0", params["conv0"], out)
    for i in SQUEEZE_FIRE:
        for part in ("squeeze", "expand1x1", "expand3x3"):
            _conv(f"features.{i}.{part}", params[f"fire{i}"][part], out)
    return out


def load_diffusion_checkpoint(path: str, cfg: Config, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference ``checkpoint_*.pt`` (a list: [0] the DataParallel state
    dict, [-1] the EMA shadow) from a local path -> the port's
    ``UNetMoreDDPM`` state dict."""
    states = torch.load(path, map_location="cpu", weights_only=True)
    sd = states[-1] if (use_ema and cfg.model.ema) else states[0]
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.startswith("all_modules."):
            k = "unet." + k
        if k.startswith("unet.all_modules."):
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# ELIC codec
# ---------------------------------------------------------------------------

# JAX ELICModel top-level names -> the reference's state-dict prefixes
_ELIC_TOP = [
    (re.compile(r"(g_a|g_s|h_a|h_s)_(\d+)$"), r"\1.\2"),
    (re.compile(r"cc_(\d+)_(\d+)$"), r"cc_transforms.\1.\2"),
    (re.compile(r"ctx_(\d+)$"), r"context_prediction.\1"),
    (re.compile(r"agg_(\d+)_(\d+)$"), r"ParamAggregation.\1.\2"),
]
# inside an attention block: conv_a_{k} -> conv_a.{k}; a residual unit's 0/2/4 -> conv.{j}
_ELIC_INNER = [
    (re.compile(r"(conv_[ab])_(\d+)$"), r"\1.\2"),
    (re.compile(r"(\d+)$"), r"conv.\1"),
]
_EB_LEAF = re.compile(r"(matrix|bias|factor)_(\d+)$")
_EB_LISTS = {"matrix": "_matrices", "bias": "_biases", "factor": "_factors"}
# compressai's CDF buffers (the port rebuilds the tables from the parameters and
# its fixed scale table), the Gaussian conditional's buffers and the context masks
_DERIVED = re.compile(r"^gaussian_conditional\.|(^|\.)(_offset|_quantized_cdf|_cdf_length|mask)$")


def _elic_leaves(tree: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for name, v in tree.items():
        if isinstance(v, dict):
            key = prefix
            if name != "conv":  # the JAX wrapper around nn.Conv
                for pat, rep in _ELIC_INNER:
                    if pat.fullmatch(name):
                        name = pat.sub(rep, name)
                        break
                key = f"{prefix}{name}."
            _elic_leaves(v, key, out)
        elif name in ("kernel", "weight") and np.ndim(v) == 4:
            # (kh, kw, I, O) conv or (kh, kw, O, I) transposed-conv kernel ->
            # PyTorch's (O, I, kh, kw) or (I, O, kh, kw)
            out[prefix + "weight"] = _tensor(np.asarray(v).transpose(3, 2, 0, 1).copy())
        else:
            out[prefix + name] = _tensor(v)


def elic_from_jax(np_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``ELICModel`` variables (``{'params': ...}``, numpy leaves) -> the
    port's ``ELICModel`` state dict, which uses the reference's keys. The
    inverse of ``tvc.utils.convert.convert_elic_state_dict``."""
    params = np_params.get("params", np_params)
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name == "entropy_bottleneck":
            for leaf, v in sub.items():
                m = _EB_LEAF.fullmatch(leaf)
                key = f"{_EB_LISTS[m.group(1)]}.{m.group(2)}" if m else leaf
                out[f"entropy_bottleneck.{key}"] = _tensor(v)
            continue
        for pat, rep in _ELIC_TOP:
            if pat.fullmatch(name):
                _elic_leaves(sub, pat.sub(rep, name) + ".", out)
                break
        else:
            raise KeyError(f"unknown ELIC parameter group {name!r}")
    return out


def load_codec_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ELIC ``*.pth.tar`` (the state dict, or ``{'state_dict': ...}``)
    from a local path -> the port's ``ELICModel`` state dict. compressai's CDF
    buffers, the Gaussian conditional's and the context convs' masks are
    dropped: the port rebuilds them."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not _DERIVED.search(k):
            out[k] = v
    return out
