"""What changes the bits of the ELIC entropy-parameter chain on the host.

    python -m tvc_torch.tools.chain_bits                 # full width, model on the card
    python -m tvc_torch.tools.chain_bits --device cpu --narrow

Runs one frame's chain (h_s, then each slice's anchor and non-anchor
parameters, on fixed seeded inputs) on the host at one thread and NCHW input,
the way ``ELICCoder`` runs it on the ``"cpu"`` backend, then again

- at other intra-op thread counts;
- with every input in the channels-last memory format;
- on the model's device (the ``"device"`` backend), when that is a card;

and prints, for each variant, how many of the output maps differ from the
reference run and by how much (largest absolute difference over the largest
value). A receiver reproduces the sender's streams only where nothing differs.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tvc_torch.core.config import CodecConfig
from tvc_torch.models.codec import checkerboard as cb
from tvc_torch.models.codec.elic import make_elic


def chain_outputs(model, inputs, device, channels_last=False):
    """The chain's 2 + 4 x num_slices output maps on ``device``."""

    def put(t):
        t = t.to(device)
        return t.contiguous(memory_format=torch.channels_last) if channels_last else t

    z, ys = inputs
    outs = []
    with torch.no_grad():
        lm, ls = model.hyper_params(put(z))
        outs += [lm, ls]
        first = None
        for i in range(model.num_slices):
            prev = put(ys[i - 1]) if i else None
            if i == 1:
                first = prev
            sup = model.slice_support(i, first, prev, lm, ls)
            outs += list(model.anchor_params(i, sup))
            outs += list(model.nonanchor_params(i, put(cb.keep_anchor(ys[i])), sup))
    return [o.float().cpu().numpy() for o in outs]


def compare(ref, got):
    differ = sum(not np.array_equal(a, b) for a, b in zip(ref, got))
    rel = max(float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)
              for a, b in zip(ref, got))
    return {"maps": len(ref), "maps_differ": differ, "max_rel_diff": rel}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m tvc_torch.tools.chain_bits")
    ap.add_argument("--device", default="cuda", help="the model's device (cuda or cpu)")
    ap.add_argument("--narrow", action="store_true",
                    help="N 16, M 24, groups (4, 4, 4, 4, 8) instead of the full width")
    args = ap.parse_args(argv)
    cfg = CodecConfig(N=16, M=24, groups=(4, 4, 4, 4, 8)) if args.narrow else CodecConfig()
    model = make_elic(cfg, seed=0, device=args.device)
    host = make_elic(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    z = torch.tensor(np.round(rng.randn(1, cfg.N, 2, 2) * 3).astype(np.float32))
    ys = [torch.tensor(np.round(rng.randn(1, g, 8, 8) * 3).astype(np.float32))
          for g in cfg.groups]

    default_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ref = chain_outputs(host, (z, ys), "cpu")
    rows = {"threads_1_again": compare(ref, chain_outputs(host, (z, ys), "cpu")),
            "channels_last": compare(ref, chain_outputs(host, (z, ys), "cpu", True))}
    for n in sorted({2, 4, default_threads}):
        torch.set_num_threads(n)
        rows[f"threads_{n}"] = compare(ref, chain_outputs(host, (z, ys), "cpu"))
    torch.set_num_threads(default_threads)
    if model.g_a[0].weight.device.type == "cuda":
        rows["device"] = compare(ref, chain_outputs(model, (z, ys), model.g_a[0].weight.device))
    report = {"codec": [cfg.N, cfg.M, list(cfg.groups)],
              "cpu_capability": torch.backends.cpu.get_cpu_capability(),
              "default_threads": default_threads, **rows}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
