"""tvc_torch stands alone: it imports neither ``jax`` nor the JAX package
``tvc``, and its entry points run on the card unless asked for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tvc_torch import cli
from tvc_torch.bench import throughput
from tvc_torch.core.config import CodecConfig, Config
from tvc_torch.metrics.fvd import FVDMetric
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.models.codec.elic import make_elic
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.models.registry import create_model
from tvc_torch.models.inception import FIDInceptionFeatures
from tvc_torch.parallel.train import make_train_step
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.pipeline.train_loop import train

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


@pytest.mark.parametrize("module", ["tvc_torch.bench.throughput", "tvc_torch.utils.fastinit",
                                    "tvc_torch.utils.profiler"])
def test_throughput_modules_import_alone_without_jax(module):
    """The throughput harness and its helpers, each imported in a fresh process."""
    probe = (f"import importlib, sys; importlib.import_module({module!r}); "
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tvc')))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout.strip()
    assert out == "[]", out


@pytest.mark.parametrize("module", [
    "tvc_torch.models.diffusion.spade", "tvc_torch.models.diffusion.layers3d",
    "tvc_torch.models.diffusion.ncsnpp3d", "tvc_torch.models.diffusion.unet_legacy",
    "tvc_torch.models.diffusion.normalization", "tvc_torch.models.diffusion.ncsnv2_blocks",
    "tvc_torch.models.registry", "tvc_torch.models.codec.layers", "tvc_torch.ops.fused_act",
    "tvc_torch.ops.resample"])
def test_model_zoo_modules_import_alone_without_jax(module):
    """Each module of the model zoo, imported in a fresh process."""
    probe = (f"import importlib, sys; importlib.import_module({module!r}); "
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tvc')))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout.strip()
    assert out == "[]", out


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


@pytest.mark.parametrize("entry", ["unet", "predictor", "lpips", "coder", "fvd", "fid_inception",
                                   "cli_codec", "cli_gop_send", "cli_gop_receive", "cli_sweep",
                                   "train_step", "train_loop", "cli_train", "fast_predictor",
                                   "bench_pipeline", "bench_main", "unet_spade", "unet_3d",
                                   "unet_pseudo3d", "legacy_unet", "predictor_3d"])
def test_default_device_raises_without_a_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "unet":
            UNetMoreDDPM(Config())
        elif entry == "predictor":
            FramePredictor.create(Config())
        elif entry == "lpips":
            LPIPSMetric.create()
        elif entry == "coder":
            make_elic(CodecConfig(N=16, M=24, groups=(4, 4, 4, 4, 8)))
        elif entry == "fvd":
            FVDMetric()
        elif entry == "fid_inception":
            FIDInceptionFeatures()
        elif entry == "train_step":
            make_train_step(Config())
        elif entry == "train_loop":
            train(Config(), np.zeros((1, 8, 64, 64, 3), np.float32), num_steps=1)
        elif entry == "fast_predictor":
            FramePredictor.create(Config(), dtype=torch.bfloat16, params_dtype=torch.bfloat16,
                                  fast_init=True)
        elif entry == "bench_pipeline":
            throughput.bench_pipeline(subsample=2)
        elif entry == "bench_main":
            throughput.main(["--quick", "--no-codec"])
        elif entry in ("unet_spade", "unet_3d", "unet_pseudo3d", "legacy_unet",
                       "predictor_3d"):
            cfg = Config()
            cfg.model.spade = entry == "unet_spade"
            cfg.model.arch = {"unet_3d": "unetmore3d", "predictor_3d": "unetmore3d",
                              "unet_pseudo3d": "unetmorepseudo3d",
                              "legacy_unet": "unet"}.get(entry, "unetmore")
            if entry == "predictor_3d":
                FramePredictor.create(cfg)
            else:
                create_model(cfg)
        else:
            frames = tmp_path / "frames.npy"
            np.save(frames, np.zeros((2, 64, 64, 3), np.float32))
            np.save(tmp_path / "d.npy", np.zeros((1, 8, 3, 64, 64), np.uint8))
            cli.main({"cli_codec": ["codec", "--input-npy", str(frames)],
                      "cli_gop_send": ["gop", "send", "--video-npy", str(frames), "--payload",
                                       str(tmp_path / "p.tvcg"), "--allow-uncalibrated"],
                      "cli_gop_receive": ["gop", "receive", "--payload",
                                          str(tmp_path / "p.tvcg")],
                      "cli_sweep": ["sweep", "--data-npy", str(frames), "--output-path",
                                    str(tmp_path / "out"), "--no-fvd",
                                    "--allow-uncalibrated"],
                      "cli_train": ["train", "--data-npy", str(tmp_path / "d.npy"),
                                    "--out-dir", str(tmp_path / "t"), "--steps", "1"]}[entry])


_RANS_PROBE = """
import numpy as np
from tvc_torch.entropy import rans
from tvc_torch.entropy.gaussian import GaussianCoder
gc = GaussianCoder()
idx = np.zeros(8, np.int32)
assert gc.decompress(gc.compress(np.ones((1, 8), np.float32), idx, np.zeros((1, 8), np.float32)),
                     idx, np.zeros((1, 8), np.float32)).sum() == 8
maps = open("/proc/self/maps").read()
print(str(rans.lib_path()) in maps, "librans_coder" in maps)
"""


def test_rans_coder_is_the_ports_own():
    """The port codes through its own build of the rANS coder, never through
    the JAX package's tracked tvc/entropy/cpp/librans_coder.so."""
    tracked = os.path.join(ROOT, "tvc", "entropy", "cpp", "librans_coder.so")
    before = os.stat(tracked).st_mtime_ns if os.path.exists(tracked) else None
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _RANS_PROBE], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout.split()
    assert out == ["True", "False"]
    after = os.stat(tracked).st_mtime_ns if os.path.exists(tracked) else None
    assert before == after
