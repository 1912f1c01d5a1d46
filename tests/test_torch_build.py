"""The rule that rebuilds a kernel library: a hash of every file under
``tvc_torch/csrc`` and of the nvcc flags, checked without nvcc (the compiler
is replaced by a stand-in that writes the library file)."""

import shutil
from pathlib import Path

import pytest

from tvc_torch.ops import _build


class FakeNvcc:
    """Stands in for ``subprocess.Popen`` of nvcc: writes the ``-o`` file."""

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, cmd, **kwargs):
        self.calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"library")
        return self

    returncode = 0

    def communicate(self):
        return "ptxas info    : Used 1 registers", None


@pytest.fixture
def toolchain(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    calls = []
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc(calls))
    return csrc, calls


def test_build_key_follows_flags_and_every_file_under_csrc(toolchain, monkeypatch):
    csrc, _ = toolchain
    key = _build.build_key("attention")
    assert _build.build_key("attention") == key
    (csrc / "extra.cuh").write_text("// a header a source may include\n")
    with_header = _build.build_key("attention")
    assert with_header != key
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.build_key("attention") != with_header


def test_build_reruns_nvcc_only_when_the_key_changes(toolchain, monkeypatch):
    csrc, calls = toolchain
    _build.build(["attention"])
    assert len(calls) == 1 and _build.lib_path("attention").exists()
    _build.build(["attention"])
    assert len(calls) == 1  # same sources, same flags: nothing to do
    (csrc / "extra.cuh").write_text("#pragma once\n")
    _build.build(["attention"])
    assert len(calls) == 2  # a new header under csrc
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-DEXTRA=1"])
    _build.build(["attention"])
    assert len(calls) == 3 and "-DEXTRA=1" in calls[-1]  # new flags
    _build.build(["attention"], force=True)
    assert len(calls) == 4


def test_first_load_builds_every_kernel_together(toolchain, monkeypatch):
    """The first launch of any kernel builds them all, one nvcc each started
    together; a later load of another kernel finds it built."""
    _, calls = toolchain
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    assert _build.load("attention") == str(_build.lib_path("attention"))
    assert sorted(Path(c[c.index("-o") + 1]).name.split(".")[0] for c in calls) == sorted(
        f"lib{n}" for n in _build.SOURCES)
    assert _build.load("groupnorm") == str(_build.lib_path("groupnorm"))
    assert len(calls) == len(_build.SOURCES)
