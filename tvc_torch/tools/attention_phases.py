"""Where the attention kernel's time goes: its device time with phases cut out.

    python -m tvc_torch.tools.attention_phases     # on the card

Builds copies of the float32 kernel ``tvc_torch/csrc/attention.cu`` into ``tvc_torch/build``,
each with some of its phases removed (the q.k product and its shuffle sum,
the p.v product, the copy of the next K/V tile), and prints each copy's time
per launch, by CUDA events over a CUDA graph of 50 launches, at the flagship
shapes. A phase's cost is the full kernel's time less the time without it.
The copies compute wrong values; they only measure. Each cut names a line of
the source, and the tool stops if a line is missing.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from tvc_torch.ops import _build
from tvc_torch.ops import attention as attn

# phase -> (line of the source, the same line with the phase behind a macro)
CUTS = {
    "QK": ("for (int kk = 0; kk < ld / 32; ++kk) {",
           "for (int kk = 0; kk < (PHASE_QK ? ld / 32 : 0); ++kk) {"),
    "PV": ("for (int n4 = 0; n4 < BK / 4; ++n4) {",
           "for (int n4 = 0; n4 < (PHASE_PV ? BK / 4 : 0); ++n4) {"),
    "COPY": ("if (it + 1 < ntiles) {", "if (PHASE_COPY && it + 1 < ntiles) {"),
}
VARIANTS = {"full": ("QK", "PV", "COPY"), "no_qk": ("PV", "COPY"), "no_pv": ("QK", "COPY"),
            "no_copy": ("QK", "PV"), "no_qk_pv": ("COPY",), "none": ()}
SHAPES = [(8, 2, 1024, 192), (1, 2, 1024, 192), (1, 3, 256, 192), (1, 4, 64, 192)]


def build_variants() -> dict:
    src = (_build.CSRC / _build.SOURCES["attention"]).read_text()
    for line, cut in CUTS.values():
        if src.count(line) != 1:
            raise RuntimeError(f"attention.cu no longer has exactly one line {line!r}")
        src = src.replace(line, cut)
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD / "attention_phases.cu"
    cu.write_text(src)
    procs = {}
    for name, kept in VARIANTS.items():
        so = _build.BUILD / f"libattention_{name}.so"
        flags = [f"-DPHASE_{p}={int(p in kept)}" for p in CUTS]
        procs[name] = (so, subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
                                             str(so), str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        fn = ctypes.CDLL(str(so)).tvc_attention_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [
            ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def graph_ms(fn, iters: int = 50, replays: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_phases runs on the card only")
    libs = build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    print("variant  " + "  ".join("x".join(map(str, s)) for s in SHAPES) + "  (ms a launch)")
    for name, fn in libs.items():
        times = []
        for b, h, t, d in SHAPES:
            q, k, v = (torch.randn((b, t, h * d), generator=g, device="cuda")
                       .view(b, t, h, d).transpose(1, 2) for _ in range(3))
            plan = attn.attention_plan(b, h, t, d, torch.float32)
            out = torch.empty((b, t, h, d), device="cuda").transpose(1, 2)
            strides = (ctypes.c_longlong * 12)(*(x.stride(i) for x in (q, k, v, out)
                                                 for i in range(3)))

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h,
                         t, d, d ** -0.5, plan.splits, plan.keys_per_split, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            times.append(graph_ms(call))
        print(f"{name:8s} " + "  ".join(f"{ms:.4f}" for ms in times), flush=True)


if __name__ == "__main__":
    main()
