"""One run of one cell: set-up, the measured window, the metrics, the check.

``run_cell`` is the whole run; ``perfbench/run.py`` is its command line. The
run makes its weights and its videos from the seed, builds the program's
objects (``tvc_torch``: the frame predictor, the ELIC coder, the LPIPS
metric and the cell's GOP runner through its runner module), warms up the shapes
the cell's traffic uses, and then measures whole units of work (a GOP, or a
lockstep batch of GOPs): it starts units until ``seconds`` have passed and
finishes the one in flight. After the window it reads the metrics, decodes
the kept keyframe streams with the program's coder (its receiver side),
frees the program's state and compares the sampled outputs with the plain
reference (the configuration's own net, its ``reference`` module, under the
shared sampler, LPIPS and ELIC).
"""

from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

from perfbench import check, record, timeline as tr, video
from perfbench.manifest import Manifest
from perfbench.peaks import peaks_for
from perfbench.weights import fill_elic_, fill_lpips_, fill_unet_, subseed

# top-level module names the measured process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "tvc")
DTYPES = ("float32", "bfloat16")
# what every configuration keeps: the shared references (the DDPM sampler,
# LPIPS, ELIC on exact streams) implement these only; the net's own settings
# are its reference module's SETTINGS
SHARED_SETTINGS = {
    "model": {"version": "DDPM", "gamma": False, "sigma_dist": "linear", "noise_in_cond": False,
              "dropout": 0.0},
    "data": {"num_frames_future": 0, "rescaled": True, "logit_transform": False,
             "uniform_dequantization": False, "gaussian_dequantization": False},
    "sampling": {"denoise": True, "clip_before": True, "init_prev_t": -1.0,
                 "precision_schedule": ""},
    "codec": {"exact_streams": True},
}
# the published widths: the built UNet's parameters against ``params_millions``
PARAMS_TOLERANCE_M = 0.05


class RunError(RuntimeError):
    """A run that cannot measure: it prints no result."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def check_settings(cfg: dict, reference: ModuleType) -> None:
    """Refuse a configuration that sets, or leaves out, a setting the shared
    references or its own reference module (``reference.SETTINGS``, its
    ``model`` keys) do not implement."""
    wanted = dict(SHARED_SETTINGS, model={**SHARED_SETTINGS["model"], **reference.SETTINGS})
    for section, keys in wanted.items():
        for key, want in keys.items():
            if key not in cfg.get(section, {}):
                raise RunError(f"the configuration does not set {section}.{key}; the plain "
                               f"reference implements {want!r} only")
            got = cfg[section][key]
            if got != want:
                raise RunError(f"the configuration sets {section}.{key}={got!r}; the plain "
                               f"reference implements {want!r} only")


def check_params(model, params_millions: float) -> None:
    """Refuse a built UNet whose parameters, of every dtype, differ from the
    configuration's ``params_millions`` by more than ``PARAMS_TOLERANCE_M``."""
    built = sum(p.numel() for p in model.parameters()) / 1e6
    if abs(built - params_millions) > PARAMS_TOLERANCE_M:
        raise RunError(f"the built UNet holds {built:.4f}M parameters; the configuration "
                       f"states params_millions={params_millions}")


class Run:
    """The state of one run; metric readers and runner modules read it."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device: str,
                 root: Optional[Path], t_start: float):
        self.t_start = t_start
        self.manifest = Manifest(root) if root is not None else Manifest()
        self.cell = self.manifest.cell(workload)
        self.config = self.manifest.config(self.cell)
        self.reference = self.manifest.reference(self.config)
        self.traffic = self.manifest.traffic(self.cell)
        self.limits = check.load_limits(self.manifest.limits_path(self.cell))
        self.metric_specs = self.manifest.metrics(self.cell, trace)
        self.seed = int(seed) % (1 << 64)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device_name = device
        self.setup_parts: Dict[str, float] = {}
        self.units: List[dict] = []
        self.window = (0.0, 0.0)
        self.peak_bytes = 0
        self.profile: Optional[dict] = None
        check_settings(self.config["config"], self.reference)
        if self.config["dtype"] not in DTYPES:
            raise RunError(f"dtype {self.config['dtype']!r} is not one of {DTYPES}")

    # ---- helpers for runner modules and metric readers ----

    def unit_seed(self, k: int) -> int:
        return subseed(self.seed, "unit", k)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def traced_window_s(self) -> float:
        """The window less the profiler's own start and stop, which a
        traced run pays inside it."""
        return self.window_s - self.recorder.prof_overhead

    @property
    def frames(self) -> int:
        return sum(u["frames"] for u in self.units)

    @property
    def unet_calls(self) -> int:
        return self.recorder.total_calls["generate"] * self.predictor.n_steps

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])

    @property
    def peaks(self) -> Optional[dict]:
        return peaks_for(self.device_kind)

    def mark(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.setup_parts[name] = t - t0
        return t

    # ---- the run ----

    def setup(self) -> None:
        t = self.mark("start", self.t_start)  # the interpreter, torch and the harness
        import torch

        if self.device_name == "cuda":
            if not torch.cuda.is_available():
                raise RunError("no CUDA device: this benchmark measures the card and does not "
                               "fall back to the CPU")
            if torch.cuda.device_count() < int(self.cell["chips"]):
                raise RunError(f"the cell asks for {self.cell['chips']} cards, "
                               f"{torch.cuda.device_count()} present")
        self.device = torch.device(self.device_name)
        self.device_kind = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                            else "cpu")
        from tvc_torch.core.config import config_from_dict
        from tvc_torch.metrics.lpips import LPIPS, LPIPSMetric
        from tvc_torch.models.codec.coding import ELICCoder
        from tvc_torch.models.codec.elic import ELICModel
        from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
        from tvc_torch.pipeline.predictor import FramePredictor

        self.tcfg = config_from_dict(self.config["config"])
        t = self.mark("imports", t)

        dtype = getattr(torch, self.config["dtype"])
        params_dtype = getattr(torch, self.config["params_dtype"])
        gen = torch.Generator(device=self.device)
        unet = UNetMoreDDPM(self.tcfg, device="meta")
        check_params(unet, self.config["params_millions"])
        unet = unet.to_empty(device=self.device)
        unet = unet.to(params_dtype)
        fill_unet_(unet, gen.manual_seed(subseed(self.seed, "unet")))
        codec = self.tcfg.codec
        elic = ELICModel(codec.N, codec.M, tuple(codec.groups), device=self.device)
        fill_elic_(elic, gen.manual_seed(subseed(self.seed, "elic")))
        lp = LPIPS(device=self.device, net_type=self.config["lpips"]["net"])
        fill_lpips_(lp, gen.manual_seed(subseed(self.seed, "lpips")))
        self.states = {"unet": dict(unet.state_dict()), "elic": dict(elic.state_dict()),
                       "lpips": dict(lp.state_dict())}
        self.sync()
        t = self.mark("weights", t)

        self.predictor = FramePredictor(
            self.tcfg, unet, dtype=dtype,
            params_dtype=None if params_dtype == torch.float32 else params_dtype)
        self.coder = ELICCoder(elic.eval(), entropy_backend=codec.entropy_backend)
        keep = self.sample_plan()
        self.recorder = record.Recorder(self.device, self.trace, keep,
                                        profile=self.traffic.get("profile"))
        record.wrap_generate(self.recorder, self.predictor)
        record.wrap_compress(self.recorder, self.coder)
        self.lpips = record.RecordedMetric(self.recorder, LPIPSMetric(lp.eval(), calibrated=False))
        self.runner = self.manifest.module("runners", self.traffic["runner"]).Workload(self)
        t = self.mark("build", t)

        self.videos = video.pool(self.seed, self.traffic)
        t = self.mark("videos", t)

        self.runner.warm()
        self.sync()
        self.recorder.total_calls = {s: 0 for s in record.SPANS}
        self.mark("warmup", t)

    def sample_plan(self) -> Dict[str, set]:
        """The calls of the window's first unit whose outputs the reference
        recomputes, drawn from the seed: ``traffic["check"][span]`` of each
        span's calls in a unit (all of them where it is at least their count)."""
        rng = np.random.default_rng([self.seed, 7])
        per_unit = self.traffic["calls_per_unit"]
        keep = {}
        for span, n in self.traffic["check"].items():
            total = int(per_unit[span])
            keep[span] = set(range(total)) if n >= total else set(
                int(i) for i in rng.choice(total, size=int(n), replace=False))
        return keep

    def measure(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.sync()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        k = 0
        while time.perf_counter() - t0 < self.seconds:
            if k >= len(self.videos):
                raise RunError(f"the traffic's pool of {len(self.videos)} units ran out before "
                               f"{self.seconds} s: raise pool_units")
            self.recorder.start_unit(k)
            t_unit = time.perf_counter()
            self.units.append(self.runner.unit(k))
            self.units[-1]["host_s"] = time.perf_counter() - t_unit
            k += 1
        self.sync()
        self.window = (t0, time.perf_counter())
        self.recorder.close()
        if self.device.type == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def reduce_trace(self) -> None:
        rec = self.recorder
        if rec.prof is None:
            return
        ev = tr.collect(rec.prof)
        a, b = rec.prof_window
        self.profile = {"kernels": ev["kernels"], "ranges": ev["ranges"],
                        "window_s": b - a, "busy_s": tr.busy_us(ev["kernels"]) / 1e6}
        print(f"[perfbench] profiled {b - a:.3f}s: {len(ev['kernels'])} device intervals, "
              f"{len(ev['ranges'])} host ranges, busy {self.profile['busy_s']:.3f}s",
              file=sys.stderr)

    def read_metrics(self) -> Dict[str, dict]:
        out = {}
        for spec in self.metric_specs:
            value = self.manifest.module("metrics", spec["name"]).read(self)
            if value is not None:
                out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
        return out

    def breakdown(self) -> Optional[dict]:
        if not self.profile:
            return None
        k, r = self.profile["kernels"], self.profile["ranges"]
        return {"device_ops": [[n, us / 1e6] for n, us in tr.by_name(k)[:10]],
                "idle_gaps": [[n, us / 1e6] for n, us in tr.gaps(k, r)[:10]]}

    def decode_streams(self) -> None:
        """The program's decoding of the kept keyframe calls' streams, for the
        comparison; after the window and the peak's reading."""
        check.decode_streams(self.coder, self.recorder.kept)

    def free_program(self) -> None:
        """Drop the program's objects (graphs, pools, runner), keeping the
        benchmark's weights and the kept outputs."""
        import torch

        self.runner = self.predictor = self.coder = self.lpips = None
        self.recorder.prof = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> dict:
        ref = check.Reference(self.reference, self.config["config"], self.float_states(), "f32")
        ref_out = ref.outputs(self.recorder.kept, self.unit_seed(record.UNIT),
                              self.device)
        values = check.numbers(check.program_outputs(self.recorder.kept, self.device), ref_out)
        values["gops_wrong"] = float(sum(u["wrong"] for u in self.units))
        return values

    def float_states(self) -> Dict[str, dict]:
        return {net: {k: v.float() for k, v in st.items()} for net, st in self.states.items()}


def check_modules() -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or of the JAX package are loaded: {found}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Optional[Path] = None, t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object. Raises ``RunError`` where
    the run cannot measure."""
    run = Run(workload, seed, seconds, trace, device, root,
              time.perf_counter() if t_start is None else t_start)
    run.setup()
    run.measure()
    check_modules()
    run.reduce_trace()
    metrics = run.read_metrics()
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": run.device_kind, "count": int(run.cell["chips"]),
           "memory_peak_bytes": run.peak_bytes}
    if run.trace and run.profile and run.profile["busy_s"] > 0:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
    breakdown = run.breakdown() if run.trace else None
    print("[perfbench] setup parts " + " ".join(f"{k}={v:.3f}s" for k, v in
                                                run.setup_parts.items()), file=sys.stderr)
    print(f"[perfbench] window {run.window_s:.3f}s units={len(run.units)} frames={run.frames} "
          f"setup_s={run.setup_s:.3f} unit_s=" + ",".join(f"{u['host_s']:.3f}" for u in run.units),
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    run.decode_streams()
    t1 = time.perf_counter()
    run.free_program()
    values = run.compare()
    print(f"[perfbench] profiler start and stop {run.recorder.prof_overhead:.3f}s in the window; "
          f"streams decoded {t1 - t0:.3f}s; reference {time.perf_counter() - t1:.3f}s",
          file=sys.stderr)
    correct, checks = check.judge(values, run.limits)
    result = {"correct": bool(correct), "attempted": sum(u["gops"] for u in run.units),
              "failed": sum(u["wrong"] for u in run.units), "metrics": metrics, "device": dev}
    if breakdown:
        result["breakdown"] = breakdown
    result["info"] = {k: values.get(k) for k in check.INFO}
    result["checks"] = checks  # the numbers compared come last
    check.print_checks(checks, values)
    check_modules()
    return result
