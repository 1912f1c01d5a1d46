"""ctypes bindings for the host rANS coder (counterpart of ``tvc/entropy/rans.py``).

The serial range coder runs on the host; the convolutions that produce its
CDF parameters run in PyTorch. The port keeps its own copy of the C++ source,
``tvc_torch/entropy/cpp/rans_coder.cpp``, and compiles it with ``g++`` into
``tvc_torch/build/`` on first use, never at import. The library is rebuilt
when its key, a hash of the source and the flags, differs from the key it was
built with. Streams are byte-compatible with the JAX package's coder.

    python -m tvc_torch.entropy.rans      # (re)build the library and print its path
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "cpp" / "rans_coder.cpp"
BUILD = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_LP = ctypes.POINTER(ctypes.c_long)


def lib_path() -> Path:
    return BUILD / "librans.so"


def key_path() -> Path:
    return BUILD / "librans.key"


def build_key() -> str:
    """Hash of the flags and the source."""
    h = hashlib.sha256("\0".join(CXX_FLAGS).encode())
    h.update(b"\0" + SRC.read_bytes())
    return h.hexdigest()


def _stale() -> bool:
    kp = key_path()
    return not lib_path().exists() or not kp.exists() or kp.read_text() != build_key()


def build(force: bool = False) -> Path:
    """Compile the coder if it is missing or was built from another source or
    flags. The library is written under a temporary name and renamed, so a
    process that loads it meanwhile sees the old file or the new one."""
    if force or _stale():
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) found to build the rANS coder")
        BUILD.mkdir(parents=True, exist_ok=True)
        key = build_key()
        tmp = BUILD / f"librans.{os.getpid()}.tmp.so"
        out = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"rANS coder build failed (exit {out.returncode}):\n{out.stderr}")
        os.replace(tmp, lib_path())
        key_path().write_text(key)
    return lib_path()


def get_lib() -> ctypes.CDLL:
    """The loaded coder, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rans_encode_with_indexes.restype = ctypes.c_long
            lib.rans_encode_with_indexes.argtypes = [
                _I32P, _I32P, ctypes.c_long, _I32P, ctypes.c_long, _I32P, _I32P,
                _U8P, ctypes.c_long]
            lib.rans_decode_with_indexes.restype = ctypes.c_long
            lib.rans_decode_with_indexes.argtypes = [
                _U8P, ctypes.c_long, _I32P, ctypes.c_long, _I32P, ctypes.c_long,
                _I32P, _I32P, _I32P]
            lib.rans_encode_batch.restype = ctypes.c_long
            lib.rans_encode_batch.argtypes = [
                _I32P, _I32P, _LP, ctypes.c_long, _I32P, ctypes.c_long, _I32P,
                _I32P, _U8P, ctypes.c_long, _LP]
            lib.rans_decode_batch.restype = ctypes.c_long
            lib.rans_decode_batch.argtypes = [
                _U8P, _LP, ctypes.c_long, _I32P, _LP, _I32P, ctypes.c_long,
                _I32P, _I32P, _I32P]
            _lib = lib
    return _lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype=np.int32)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _tables(cdfs, cdf_lengths, offsets):
    cdfs = np.ascontiguousarray(cdfs, dtype=np.int32)
    if cdfs.ndim != 2:
        raise ValueError(f"cdfs must be (num_cdfs, stride), got shape {cdfs.shape}")
    cl, off = _i32(cdf_lengths), _i32(offsets)
    if cl.size != cdfs.shape[0] or off.size != cdfs.shape[0]:
        raise ValueError("cdf_lengths and offsets need one entry per CDF row")
    return cdfs, cl, off


def _check_indexes(ind: np.ndarray, n_cdfs: int) -> None:
    if ind.size and (ind.min() < 0 or ind.max() >= n_cdfs):
        raise ValueError(f"CDF index out of range [0, {n_cdfs})")


def finite_latents(x: np.ndarray) -> np.ndarray:
    """``x``, latents less their means or medians, where every value casts to
    an int32 symbol. NaN, inf and |x| >= 2^31 cast to INT_MIN, whose escape
    coding in the rANS coder never ends: such latents are refused instead."""
    if not (np.abs(x) < 2.0 ** 31 - 1).all():
        raise ValueError("non-finite latents: the entropy model gave NaN, inf or a value "
                         "outside the int32 symbols, which the rANS coder cannot code")
    return x


class RansEncoder:
    """Encodes symbols against indexed quantized CDFs (API of compressai's
    ``BufferedRansEncoder``)."""

    def encode_with_indexes(self, symbols: Sequence[int], indexes: Sequence[int],
                            cdfs: np.ndarray, cdf_lengths: Sequence[int],
                            offsets: Sequence[int]) -> bytes:
        return self.encode_batch(symbols, indexes, [np.asarray(symbols).size], cdfs,
                                 cdf_lengths, offsets)[0]

    def encode_batch(self, symbols: np.ndarray, indexes: np.ndarray, counts: Sequence[int],
                     cdfs: np.ndarray, cdf_lengths: Sequence[int],
                     offsets: Sequence[int]) -> List[bytes]:
        """``symbols``/``indexes``: the streams' symbols concatenated;
        ``counts``: symbols per stream. One byte string per stream."""
        lib = get_lib()
        sym, ind = _i32(symbols), _i32(indexes)
        cnt = np.ascontiguousarray(counts, dtype=np.int64)
        cdfs, cl, off = _tables(cdfs, cdf_lengths, offsets)
        if sym.size != ind.size or int(cnt.sum()) != sym.size:
            raise ValueError("symbols, indexes and counts disagree in size")
        _check_indexes(ind, cdfs.shape[0])
        cap = max(64, sym.size * 8 + 64 * len(cnt) + 64)
        out = np.empty(cap, dtype=np.uint8)
        sizes = np.zeros(len(cnt), dtype=np.int64)
        n = lib.rans_encode_batch(_ptr(sym, _I32P), _ptr(ind, _I32P), _ptr(cnt, _LP), len(cnt),
                                  _ptr(cdfs, _I32P), cdfs.shape[1], _ptr(cl, _I32P),
                                  _ptr(off, _I32P), _ptr(out, _U8P), cap, _ptr(sizes, _LP))
        if n < 0:
            raise RuntimeError("rans encode: output buffer too small")
        res, o = [], 0
        for s in sizes:
            res.append(out[o: o + int(s)].tobytes())
            o += int(s)
        return res


class RansDecoder:
    """Decodes streams written by ``RansEncoder`` (API of compressai's ``RansDecoder``)."""

    def decode_with_indexes(self, data: bytes, indexes: Sequence[int], cdfs: np.ndarray,
                            cdf_lengths: Sequence[int], offsets: Sequence[int]) -> np.ndarray:
        return self.decode_batch([data], indexes, [np.asarray(indexes).size], cdfs,
                                 cdf_lengths, offsets)

    def decode_batch(self, datas: Sequence[bytes], indexes: np.ndarray, counts: Sequence[int],
                     cdfs: np.ndarray, cdf_lengths: Sequence[int],
                     offsets: Sequence[int]) -> np.ndarray:
        """The streams' symbols, concatenated (int32)."""
        lib = get_lib()
        ind = _i32(indexes)
        cnt = np.ascontiguousarray(counts, dtype=np.int64)
        sizes = np.ascontiguousarray([len(d) for d in datas], dtype=np.int64)
        if len(cnt) != len(datas) or int(cnt.sum()) != ind.size:
            raise ValueError("indexes and counts disagree with the streams")
        if any(s < 8 or s % 4 for s in sizes):
            raise ValueError("a rANS stream is a whole number (>= 2) of 32-bit words")
        cdfs, cl, off = _tables(cdfs, cdf_lengths, offsets)
        _check_indexes(ind, cdfs.shape[0])
        blob = np.frombuffer(b"".join(datas), dtype=np.uint8).copy()
        out = np.empty(ind.size, dtype=np.int32)
        rc = lib.rans_decode_batch(_ptr(blob, _U8P), _ptr(sizes, _LP), len(datas),
                                   _ptr(ind, _I32P), _ptr(cnt, _LP), _ptr(cdfs, _I32P),
                                   cdfs.shape[1], _ptr(cl, _I32P), _ptr(off, _I32P),
                                   _ptr(out, _I32P))
        if rc != 0:
            raise RuntimeError("rans decode failed")
        return out


if __name__ == "__main__":
    print(build(force=True))
