"""The control of each cell: the reference one precision lower in the
program's place fails a number the program passes (on the card, at tiny
sizes; ``perfbench/control.py`` reads it at the cells' own sizes)."""

from __future__ import annotations

import pytest
import torch

from perfbench.check import judge, load_limits
from perfbench.control import readings


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny.gop", "tiny.lock"])
def test_control_fails_and_program_passes(tiny_root, card, cell):
    limits = load_limits(tiny_root / f"perfbench/limits/{cell}.json")
    for seed in (11, 12, 13):
        row = readings(cell, seed, device=card, root=tiny_root)
        assert judge(row["program"], limits)[0] is True
        ctl = dict(row["control"], gops_wrong=0.0)
        assert judge(ctl, limits)[0] is False
