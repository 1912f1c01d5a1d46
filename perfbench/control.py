"""Readings for the limits of ``correct``: the program's and the control's.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13

For each seed, in one process: set up the cell as a run does, measure a
window of one unit of work at the cell's own load and sizes, compare
the program's sampled outputs with the float32 reference, and compare the
control's, the same reference one precision lower (TF32 under a float32
configuration, fp8 under bfloat16) put in the program's place on the same
inputs, with the same float32 reference. Prints one JSON line a seed:
``{"seed", "program": {number: value}, "control": {number: value},
"control_precision"}``. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]


def readings(workload: str, seed: int, device: str = "cuda", root=None) -> dict:
    import torch

    from perfbench import check, record
    from perfbench.harness import Run
    from perfbench.reference.precision import CONTROL

    # a window shorter than any unit: the run measures exactly one
    run = Run(workload, seed, 1e-3, False, device, root, time.perf_counter())
    run.setup()
    run.measure()
    run.decode_streams()
    run.free_program()
    states = run.float_states()
    kept, unit_seed = run.recorder.kept, run.unit_seed(record.UNIT)
    cfg = run.config["config"]
    ref = check.Reference(run.reference, cfg, states, "f32").outputs(kept, unit_seed, run.device)
    program = check.numbers(check.program_outputs(kept, run.device), ref)
    program["gops_wrong"] = float(sum(u["wrong"] for u in run.units))
    precision = CONTROL[run.config["dtype"]]
    ctl = check.Reference(run.reference, cfg, states, precision).outputs(kept, unit_seed,
                                                                         run.device)
    control = check.numbers(ctl, ref)
    out = {"seed": seed, "workload": workload, "units": len(run.units),
           "program": program, "control": control, "control_precision": precision}
    del run, states, ref, ctl
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        row = readings(args.workload, int(s))
        row["wall_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
