"""Cross-package decode at the default codec width (N 192, M 320): a container
written by ``tvc/`` decodes in the port to ``tvc/``'s symbols, stream by
stream, and to its reconstruction within 1e-4 x its largest value.

The fixture (``tvc_torch/testdata/cross_decode_elic.npz``, see
``tvc_torch/tools/cross_decode.py``) was written on the CPU by

    JAX_PLATFORMS=cpu python tests/test_torch_cross_decode.py --write

from weights drawn by ``numpy.random.default_rng``; the test draws them again
and fails, saying so, if their SHA-256 is not the fixture's. The same decode
on the card is a card-only test in ``tests/test_torch_gpu.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.models.codec import container as jcontainer
from tvc.models.codec.coding import ELICCoder as JELICCoder
from tvc.models.codec.elic import ELICModel as JELICModel
from tvc.utils.convert import convert_elic_state_dict
from tvc_torch.tools import cross_decode as xd


def frames():
    return np.random.default_rng(xd.SEED + 1).random((2, 128, 128, 3), dtype=np.float32)


def jax_coder(model):
    return JELICCoder(JELICModel(N=xd.N, M=xd.M, groups=xd.GROUPS),
                      convert_elic_state_dict(model.state_dict(), groups=xd.GROUPS),
                      entropy_backend="cpu")


def _recording(dec, rows):
    orig = dec.decode_batch

    def rec(*args):
        out = orig(*args)
        rows.extend(np.asarray(out).reshape(len(args[0]), -1))
        return out

    dec.decode_batch = rec


def write_fixture(path=xd.FIXTURE):
    """Code the frames with ``tvc/``'s ELICCoder and store what it decodes."""
    model = xd.draw_weights(xd.SEED)
    jport = jax_coder(model)
    blob = jcontainer.serialize(jport.compress(frames()), entropy_backend="cpu")
    enc = jcontainer.deserialize(blob, expect_entropy_backend="cpu")
    y_strings, z_strings = enc["strings"]
    rows = []
    _recording(jport.fb._dec, rows)
    _recording(jport.gc._dec, rows)
    z_hat = jport.fb.decompress(z_strings, enc["shape"])
    for f in range(z_hat.shape[0]):  # one frame at a time: decompress runs frames on threads
        jport._decode_frame_entropy(y_strings, f, z_hat[f: f + 1])
    names = xd.stream_names(z_hat.shape[0])
    assert len(rows) == len(names)
    x_hat = np.asarray(jport.decompress(enc["strings"], enc["shape"])["x_hat"], np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, container=np.frombuffer(blob, np.uint8), seed=np.int64(xd.SEED),
                        weights_sha256=np.asarray(xd.weights_sha256(model)), x_hat=x_hat,
                        **{n: np.asarray(r, np.int32) for n, r in zip(names, rows)})
    return path


@pytest.fixture(scope="module")
def decoded():
    return xd.decode("cpu")


def test_default_width_tvc_container_decodes_in_port(decoded):
    print(f"cross-package decode on the CPU: {decoded['matched']} of {decoded['streams']} "
          f"streams give tvc's symbols; x_hat within {decoded['x_hat_max_abs_diff']:.3g}")
    assert decoded["streams"] == 2 + 2 * 2 * len(xd.GROUPS)
    assert decoded["matched"] == decoded["streams"], \
        [n for n, ok in decoded["per_stream"].items() if not ok]
    assert decoded["x_hat_max_abs_diff"] <= 1e-4 * decoded["x_hat_max_abs"]


def test_fixture_codes_more_than_zeros():
    fx = xd.load_fixture()
    syms = np.concatenate([fx[n].reshape(-1) for n in xd.stream_names(2)])
    assert np.abs(syms).max() >= 3 and len(np.unique(syms)) >= 5
    assert fx["x_hat"].shape == (2, 128, 128, 3)
    assert os.path.getsize(xd.FIXTURE) < 1 << 20


def test_a_weight_hash_mismatch_fails_with_that_reason(tmp_path):
    fx = xd.load_fixture()
    fx["weights_sha256"] = np.asarray("0" * 64)
    path = tmp_path / "other.npz"
    np.savez(path, **fx)
    with pytest.raises(ValueError, match="weight hash mismatch"):
        xd.decode("cpu", str(path))


def test_decode_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Like every entry point of the port, ``decode`` defaults to the card, and
    on a host without one it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xd.decode()


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit("usage: python tests/test_torch_cross_decode.py --write")
    jax.config.update("jax_platforms", "cpu")
    jnp.zeros(1).block_until_ready()
    print("wrote", write_fixture())
