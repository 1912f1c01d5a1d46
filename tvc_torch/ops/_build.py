"""Build and load the port's CUDA kernels.

Each source under ``tvc_torch/csrc`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, in ``tvc_torch/build``, on
first use; the wrappers load it with ``ctypes``. Nothing is built at import
time, and nothing here runs on a host without the CUDA toolkit unless a kernel
is launched. Sources are compiled in parallel, one ``nvcc`` each, all of them
at the first load. A library is rebuilt when its key, a hash of every file
under ``csrc`` and of the flags, differs from the key it was built with. Each
compilation counts as ``kernels.builds`` in ``utils/profiler.py``.

    python -m tvc_torch.ops._build      # build every kernel, print ptxas reports
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

from tvc_torch.utils import profiler

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

# kernel name -> source file under csrc/
SOURCES = {"attention": "attention.cu", "attention_tc": "attention_tc.cu",
           "groupnorm": "groupnorm.cu", "fir": "fir.cu"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build tvc_torch kernels")


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def report_path(name: str) -> Path:
    """The ``-Xptxas -v`` report (registers, shared memory, spills) of the last build."""
    return BUILD / f"lib{name}.ptxas.txt"


def key_path(name: str) -> Path:
    return BUILD / f"lib{name}.key"


def build_key(name: str) -> str:
    """Hash of the kernel's name, the flags and every file under ``csrc`` (a
    source includes what it likes from there)."""
    h = hashlib.sha256("\0".join([name, SOURCES[name], *NVCC_FLAGS]).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(b"\0" + path.relative_to(CSRC).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()


def _stale(name: str) -> bool:
    kp = key_path(name)
    return not lib_path(name).exists() or not kp.exists() or kp.read_text() != build_key(name)


def build(names: Iterable[str] = tuple(SOURCES), force: bool = False) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are missing or were built
    from other sources or flags; one ``nvcc`` process per source, all started
    together.
    Returns each kernel's ptxas report."""
    names = list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if force or _stale(n)]
    profiler.count("kernels.builds", len(todo))
    procs = {}
    for n in todo:
        tmp = BUILD / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, build_key(n), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, key, p) in procs.items():
        out, _ = p.communicate()
        report_path(n).write_text(out)
        if p.returncode != 0:
            failed.append(f"{SOURCES[n]} (nvcc exit {p.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
            key_path(n).write_text(key)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {n: report_path(n).read_text() if report_path(n).exists() else "" for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``. The first load builds every
    kernel that is missing or stale, all together (a process that launches
    one kernel launches the others soon after: the UNet runs the attention
    and GroupNorm kernels), so their ``nvcc`` runs overlap."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(SOURCES if not _libs else [name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


if __name__ == "__main__":
    for kname, rep in build(force=True).items():
        print(f"== {kname}: {SOURCES[kname]}\n{rep}")
