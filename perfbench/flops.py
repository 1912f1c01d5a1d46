"""Operations and bytes of the UNet's work, frozen from a configuration's shapes.

Counted from the architecture, never from a run of the program, so that the
counts stay what the work needs however a later change computes it. One
multiply-add is 2 operations. Counted: every convolution (the FIR
resampling as the 4x4 depthwise convolution it is), every dense and NIN
product, and the two products of each attention head (q k^T and p v).
Normalisations, activations, the softmax and the sampler's per-step
arithmetic are not counted: they are a small share of the operations, and
elementwise.
"""

from __future__ import annotations

from typing import List, Tuple

from perfbench.reference.unet import module_plan

FIR_TAPS = 16  # the 4x4 (outer product of a 4-tap) FIR kernel


def conv_flops(c_in: int, c_out: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * c_in * c_out * k * k * h_out * w_out


def attention_heads(ch: int, head_channels: int) -> int:
    return 1 if ch < head_channels else ch // head_channels


def attention_launches(cfg: dict) -> List[Tuple[int, int, int]]:
    """(heads, tokens, head dim) of each attention call of one UNet call, in order."""
    hc = cfg["model"]["n_head_channels"]
    out = []
    for p in module_plan(cfg):
        if p["kind"] == "attn":
            heads = attention_heads(p["ch"], hc)
            out.append((heads, p["res"] ** 2, p["ch"] // heads))
    return out


def attention_flops(batch: int, heads: int, tokens: int, d: int) -> float:
    return 4.0 * batch * heads * tokens * tokens * d


def attention_bytes(batch: int, heads: int, tokens: int, d: int, itemsize: int) -> float:
    """q, k and v read once, the output written once."""
    return 4.0 * batch * heads * tokens * d * itemsize


def unet_flops(cfg: dict, batch: int = 1) -> float:
    """Operations of one UNet call at ``batch``."""
    m, d = cfg["model"], cfg["data"]
    nf = m["ngf"]
    hc = m["n_head_channels"]
    total = 2.0 * nf * 4 * nf + 2.0 * 4 * nf * 4 * nf       # the two time-embedding denses
    for p in module_plan(cfg):
        kind = p["kind"]
        if kind == "conv":
            total += conv_flops(p["in"], p["out"], 3, p["res"], p["res"])
        elif kind == "res":
            r_in = p["res"]
            r_out = r_in * 2 if p.get("up") else r_in // 2 if p.get("down") else r_in
            # the two adaptive norms' dense projections of the embedding
            total += 2.0 * 4 * nf * 2 * p["in"] + 2.0 * 4 * nf * 2 * p["out"]
            if p.get("up") or p.get("down"):
                # FIR on the block's input and on its skip, each per channel
                total += 2 * 2.0 * FIR_TAPS * p["in"] * r_out * r_out
            total += conv_flops(p["in"], p["out"], 3, r_out, r_out)
            total += conv_flops(p["out"], p["out"], 3, r_out, r_out)
            if p["in"] != p["out"] or p.get("up") or p.get("down"):
                total += conv_flops(p["in"], p["out"], 1, r_out, r_out)
        elif kind == "attn":
            t, c = p["res"] ** 2, p["ch"]
            heads = attention_heads(c, hc)
            total += 4 * 2.0 * t * c * c + attention_flops(1, heads, t, c // heads)
    return total * batch


def unet_attention_bound_s(cfg: dict, batch: int, itemsize: int, peak_flops: float,
                           peak_bytes_s: float) -> float:
    """The least time the attention calls of one UNet call can take on the
    chip: per call the larger of operations over the peak and bytes over the
    memory's rate, summed."""
    return sum(max(attention_flops(batch, h, t, dd) / peak_flops,
                   attention_bytes(batch, h, t, dd, itemsize) / peak_bytes_s)
               for h, t, dd in attention_launches(cfg))
