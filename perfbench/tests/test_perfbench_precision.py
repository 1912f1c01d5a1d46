"""The reference's lower precisions, used by the controls."""

from __future__ import annotations

import torch

from perfbench.reference.precision import CONTROL, Precision, round_fp8, round_tf32


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, 1.0 + 2 ** -12, -3.0])
    y = round_tf32(x)
    assert y[0] == 1.0 + 2 ** -10
    assert y[1] == 1.0 + 2 ** -10      # above half an ulp: up
    assert y[2] == 1.0                 # below half an ulp: down
    assert y[3] == -3.0
    z = torch.randn(10000)
    rel = ((round_tf32(z) - z).abs() / z.abs()).max()
    assert 0 < rel <= 2 ** -11


def test_fp8_rounds_to_e4m3_under_one_scale():
    z = torch.randn(10000)
    q = round_fp8(z)
    scale = z.abs().max() / 448.0
    assert torch.equal((q / scale).to(torch.float8_e4m3fn).float() * scale, q)
    big = z.abs() > 0.1
    rel = ((q - z).abs() / z.abs())[big].max()
    assert 2 ** -6 < rel <= 2 ** -4


def test_controls_and_the_float32_path():
    assert CONTROL == {"float32": "tf32", "bfloat16": "fp8"}
    x, w = torch.randn(2, 3, 5, 5), torch.randn(4, 3, 3, 3)
    f32 = Precision("f32").conv2d(x, w, padding=1)
    assert torch.equal(f32, torch.nn.functional.conv2d(x, w, padding=1))
    for mode in ("tf32", "fp8"):
        lo = Precision(mode).conv2d(x, w, padding=1)
        assert 0 < float((lo - f32).abs().max())
