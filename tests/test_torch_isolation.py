"""tvc_torch stands alone: it imports neither ``jax`` nor the JAX package
``tvc``, and its entry points run on the card unless asked for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from tvc_torch.core.config import Config
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.pipeline.predictor import FramePredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import tvc_torch
names = [m.name for m in pkgutil.walk_packages(tvc_torch.__path__, "tvc_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tvc"))
print(len(names), ",".join(bad))
"""


def test_importing_every_module_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout.split()
    assert int(out[0]) >= 15, out  # every module of the slice was imported
    assert len(out) == 1, f"tvc_torch imported {out[1]}"


@pytest.mark.parametrize("path", ["chip_smoke.py", "tvc_torch"])
def test_sources_name_no_jax(path):
    """No import statement of the port or its chip script names jax, flax or tvc."""
    full = os.path.join(ROOT, path)
    files = [full]
    if not full.endswith(".py"):
        files = []
        for d, dirs, fs in os.walk(full):
            dirs[:] = [x for x in dirs if x != "build"]  # generated output, not source
            files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "flax", "tvc"), (f, m)


@pytest.mark.parametrize("entry", ["unet", "predictor", "lpips"])
def test_default_device_raises_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "unet":
            UNetMoreDDPM(Config())
        elif entry == "predictor":
            FramePredictor.create(Config())
        else:
            LPIPSMetric.create()
