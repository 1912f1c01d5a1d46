"""What the benchmark records around the program's calls.

The harness wraps three calls of the program's objects, never its code: the
predictor instance's ``generate`` (span ``generate``), the LPIPS metric the
runner is given (span ``score``) and the keyframe coder instance's
``compress`` (span ``keyframe``). Each wrapper

- counts its calls within the current unit of work;
- keeps, for the correctness comparison, its inputs and outputs where the
  call is one of the sample drawn for the comparison (references only: no
  copy and no device work in the window);
- with tracing on, waits for the device before and after the call, records a
  host span and a profiler range named ``perfbench.<span>``, and starts or
  stops the profiler where the traffic file places the profiled interval.

Without tracing the wrappers only count and keep.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPANS = ("generate", "score", "keyframe")
UNIT = 0  # the unit of the window whose calls are kept and profiled: its first


class Recorder:
    def __init__(self, device: torch.device, trace: bool, keep: Dict[str, set],
                 profile: Optional[dict] = None):
        self.device = device
        self.trace = trace
        self.keep = keep            # span -> indexes (within the kept unit) to keep
        self.kept: Dict[str, List[Tuple[int, dict]]] = {s: [] for s in SPANS}
        self.spans: List[Tuple[str, float, float]] = []
        self.calls = {s: 0 for s in SPANS}
        self.total_calls = {s: 0 for s in SPANS}
        self.unit = -1
        self.profile = profile if trace else None
        self.prof = None            # the torch.profiler session, once started
        self.prof_window: Optional[Tuple[float, float]] = None
        self.prof_overhead = 0.0    # host seconds spent starting and stopping it

    def start_unit(self, k: int) -> None:
        self.unit = k
        self.calls = {s: 0 for s in SPANS}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _trigger(self, when: str, span: str, index: int) -> None:
        if self.profile is None or self.unit != UNIT:
            return
        for action in ("start", "stop"):
            w, s, i = self.profile[action]
            if (w, s, i) != (when, span, index):
                continue
            self._sync()
            if action == "start" and self.prof is None:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                t0 = time.perf_counter()
                self.prof = profile(activities=acts)
                self.prof.start()
                self.prof_window = (time.perf_counter(), None)
                self.prof_overhead += self.prof_window[0] - t0
            elif action == "stop" and self.prof is not None and self.prof_window[1] is None:
                self._stop()

    def _stop(self) -> None:
        self.prof_window = (self.prof_window[0], time.perf_counter())
        self.prof.stop()
        self.prof_overhead += time.perf_counter() - self.prof_window[1]

    def call(self, span: str, fn: Callable, args, kwargs, keep: Callable[[tuple, dict, object], dict]):
        i = self.calls[span]
        self.calls[span] += 1
        self.total_calls[span] += 1
        self._trigger("before", span, i)
        if self.trace:
            self._sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"perfbench.{span}"):
                out = fn(*args, **kwargs)
                self._sync()
            self.spans.append((span, t0, time.perf_counter()))
        else:
            out = fn(*args, **kwargs)
        if self.unit == UNIT and i in self.keep.get(span, ()):
            self.kept[span].append((i, keep(args, kwargs, out)))
        self._trigger("after", span, i)
        return out

    def close(self) -> None:
        """Stop a profiler that is still running (a unit that ended early)."""
        if self.prof is not None and self.prof_window[1] is None:
            self._sync()
            self._stop()


def _generate_record(args, kwargs, out):
    return {"cond": args[0] if args else kwargs["cond_frames"], "pred": out}


def wrap_generate(rec: Recorder, predictor) -> None:
    """``predictor.generate`` through the recorder (an instance attribute)."""
    orig = predictor.generate

    def generate(*args, **kwargs):
        return rec.call("generate", orig, args, kwargs, _generate_record)

    predictor.generate = generate


class RecordedMetric:
    """The LPIPS metric as the runner calls it: ``metric(pred, gt) -> scores``."""

    def __init__(self, rec: Recorder, metric):
        self.rec = rec
        self.metric = metric

    def __call__(self, a, b):
        return self.rec.call("score", self.metric, (a, b), {},
                             lambda args, kw, out: {"a": args[0], "b": args[1], "scores": out})


def _compress_record(args, kwargs, out):
    return {"x": args[0], "x_hat": out["x_hat"], "strings": out["strings"],
            "shape": out["shape"]}


def wrap_compress(rec: Recorder, coder) -> None:
    """``coder.compress`` through the recorder (an instance attribute)."""
    orig = coder.compress

    def compress(*args, **kwargs):
        return rec.call("keyframe", orig, args, kwargs, _compress_record)

    coder.compress = compress
