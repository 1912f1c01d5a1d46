"""The benchmark of ``tvc_torch`` on the card: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, the
numbers compared with the reference beside their limits (also the last lines
of standard error). Exits 1 and prints no result where it cannot measure: no
card, fewer cards than the cell asks for, a configuration setting what its
plain reference does not implement or a UNet of other widths than it states,
or modules of JAX or of the JAX package loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# import from the checkout's root, never from this script's own folder
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # keep every library that could load JAX from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from perfbench.harness import RunError, run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START)
    except RunError as e:
        print(f"[perfbench] cannot measure: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
