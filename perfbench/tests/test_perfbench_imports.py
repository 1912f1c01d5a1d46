"""No module of JAX or of the JAX package in the harness's process, and
nothing of the program in the reference's."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "tvc"}

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    __import__(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(mods):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(REPO), mods=mods)],
                         capture_output=True, text=True, check=True, cwd=str(REPO), timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax_and_no_jax_package():
    loaded = top_level_modules(["perfbench.harness", "perfbench.control", "perfbench.check",
                                "perfbench.runners.device_gop", "perfbench.runners.lockstep",
                                "tvc_torch.cli", "tvc_torch.pipeline.batched"])
    assert "tvc_torch" in loaded and "perfbench" in loaded
    # whole top-level names: tvc_torch begins with tvc and is allowed
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    references = sorted(f"perfbench.reference.{p.stem}"
                        for p in (REPO / "perfbench/reference").glob("*.py"))
    assert {"perfbench.reference.unet", "perfbench.reference.ddpm"} <= set(references)
    loaded = top_level_modules(references + ["perfbench.flops", "perfbench.peaks",
                                             "perfbench.timeline", "perfbench.video",
                                             "perfbench.weights"])
    assert not loaded & (FORBIDDEN | {"tvc_torch"})


def test_forbidden_check_compares_whole_names():
    from perfbench.harness import forbidden_modules

    sys.modules.setdefault("tvc_torch_like_name", type(sys)("tvc_torch_like_name"))
    try:
        assert "tvc" not in forbidden_modules()
        sys.modules["tvc"] = type(sys)("tvc")
        assert forbidden_modules() == ["tvc"]
    finally:
        sys.modules.pop("tvc", None)
        sys.modules.pop("tvc_torch_like_name", None)
