"""The reference coder follows both roundings of a value within rounding of a half."""

from __future__ import annotations

import torch

from perfbench.reference.elic import MAX_ROWS, MAX_TIES, PlainELIC


def test_a_near_tie_is_followed_both_ways():
    v = torch.tensor([[[[0.2, 1.5 + 1e-7]]], [[[2.4, -0.7]]]])  # (R=2, C=1, H=1, W=2)
    frame = torch.tensor([0, 1])
    sym, src, default = PlainELIC._round(v, v.abs(), None, frame, torch.tensor([True, True]))
    assert src.tolist() == [0, 0, 1]
    assert sorted(sym[:2, 0, 0, 1].tolist()) == [1.0, 2.0]
    assert (sym[:2, 0, 0, 0] == 0.0).all() and torch.equal(sym[2], torch.round(v[1]))
    # one row of each frame keeps the usual rounding
    assert default.tolist().count(True) == 2
    assert torch.equal(sym[default], torch.round(v))


def test_ties_outside_the_mask_or_past_the_caps_keep_the_usual_rounding():
    v = torch.full((1, 1, 1, MAX_TIES + 1), 0.5)
    frame = torch.tensor([0])
    sym, src, default = PlainELIC._round(v, v.abs(), None, frame, torch.tensor([True]))
    assert len(sym) == 1 and torch.equal(sym, torch.round(v))
    mask = torch.tensor([[True] + [False] * MAX_TIES])
    sym, src, default = PlainELIC._round(v, v.abs(), mask, frame, torch.tensor([True]))
    assert len(sym) == 2 and default.tolist().count(True) == 1
    rows = torch.zeros(MAX_ROWS, dtype=torch.long)  # a frame already at its cap
    v = torch.full((MAX_ROWS, 1, 1, 1), 0.5)
    sym, src, default = PlainELIC._round(v, v.abs(), None, rows, torch.ones(MAX_ROWS, dtype=torch.bool))
    assert len(sym) == MAX_ROWS
