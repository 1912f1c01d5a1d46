"""Train-state snapshots as npz, no pickle (counterpart of ``tvc/utils/checkpoint_io.py``).

A snapshot ``<path>`` is four files, named as the JAX package names them:
``<path>.params.npz`` and ``<path>.ema.npz`` (the UNet's state dict),
``<path>.step.npy`` and ``<path>.opt.npz`` (the optimizer state of
``tvc_torch.losses.optimizers``, optional).

``load_train_state`` also reads a snapshot the JAX package wrote: its params
and EMA (``params/unet/m{i}/...`` paths) through ``unet_from_jax``, and its
optax state (``<chain index>/.count``, ``.mu/...``, ``.nu/...``,
``.trace/...``) onto the port's keys, so a run of ``tvc`` resumes here.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tvc_torch.core.config import Config
from tvc_torch.utils.convert import unet_from_jax

Tensors = Dict[str, torch.Tensor]
_OPTAX_KEY = re.compile(r"^((?:\d+/)+)\.(count|mu|nu|trace)(?:/(.*))?$")


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_tree(path: str, tree: Tensors) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(_npz(path), **{k: v.detach().cpu().numpy() for k, v in tree.items()})


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    """``a/b/c`` keys -> nested dicts."""
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _from_optax(flat: Dict[str, np.ndarray], cfg: Config) -> Tensors:
    """An optax chain state of the JAX package's ``get_optimizer`` -> the port's keys."""
    counts, slots = {}, {}
    for key, arr in flat.items():
        m = _OPTAX_KEY.match(key)
        if m is None:
            raise ValueError(f"not an optax state key of the JAX package: {key!r}")
        prefix, field, rest = m.groups()
        if field == "count":
            counts[prefix] = arr
        else:
            slots.setdefault(field, {})[rest] = arr
    out: Tensors = {}
    adam_prefix = next((m.group(1) for m in map(_OPTAX_KEY.match, flat) if m.group(2) == "mu"),
                       None)
    for prefix, arr in counts.items():
        out["adam_count" if prefix == adam_prefix else "count"] = torch.tensor(int(arr))
    for field, tree in slots.items():
        for name, t in unet_from_jax(cfg, _nest(tree)).items():
            out[f"{field}/{name}"] = t
    return out


def load_tree_into(path: str, template: Tensors, cfg: Optional[Config] = None) -> Tensors:
    """The arrays of ``path`` as tensors shaped, typed and placed like
    ``template``'s (a 0-dim template tensor stays on the host). A file the
    JAX package wrote is converted (``cfg`` names its UNet)."""
    with np.load(_npz(path)) as data:
        flat = {k: data[k] for k in data.files}
    if flat and all("/" in k for k in flat):
        if cfg is None:
            raise ValueError(f"{path} was written by the JAX package; pass its cfg to convert it")
        optax_state = all(_OPTAX_KEY.match(k) for k in flat)
        tensors = _from_optax(flat, cfg) if optax_state else unet_from_jax(cfg, _nest(flat))
    else:
        tensors = {k: torch.from_numpy(v) for k, v in flat.items()}
    if set(tensors) != set(template):
        missing, extra = sorted(set(template) - set(tensors)), sorted(set(tensors) - set(template))
        raise ValueError(f"{path}: missing {missing[:5]}, unexpected {extra[:5]}")
    out = {}
    for k, leaf in template.items():
        t = tensors[k]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: {k} has shape {tuple(t.shape)}, expected {tuple(leaf.shape)}")
        out[k] = t.to(dtype=leaf.dtype, device=leaf.device).contiguous()
    return out


def save_train_state(path: str, params: Tensors, ema: Tensors, step: int,
                     opt_state: Optional[Tensors] = None) -> None:
    save_tree(path + ".params", params)
    save_tree(path + ".ema", ema)
    np.save(path + ".step.npy", np.asarray(step))
    if opt_state is not None:
        save_tree(path + ".opt", opt_state)


def load_train_state(path: str, params_template: Tensors, ema_template: Tensors,
                     opt_template: Optional[Tensors] = None, cfg: Optional[Config] = None
                     ) -> Tuple[Tensors, Tensors, int, Optional[Tensors]]:
    params = load_tree_into(path + ".params", params_template, cfg)
    ema = load_tree_into(path + ".ema", ema_template, cfg)
    step = int(np.load(path + ".step.npy"))
    opt = load_tree_into(path + ".opt", opt_template, cfg) if opt_template is not None else None
    return params, ema, step, opt
