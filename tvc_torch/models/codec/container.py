"""On-disk container of coded frames (counterpart of ``tvc/models/codec/container.py``,
byte-compatible both ways).

    magic 'TVC1' | u16 num_slices | u16 batch | u16 zH | u16 zW
    then the z streams, then per slice the anchor and non-anchor streams,
    each stream as u32 length + bytes, batch-major within each phase.

'TVC2' adds a coding-profile byte after the header, the entropy backend
(0: "cpu", 1: "device"): the entropy parameters are reproducible only on the
backend that made them, and rANS has no checksum, so a receiver with the
other backend refuses the container instead of decoding garbage. TVC1 (no
profile) is what ``serialize`` writes when no backend is given.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"TVC1"
MAGIC2 = b"TVC2"

_BACKEND_TO_ID = {"cpu": 0, "device": 1}
_ID_TO_BACKEND = {v: k for k, v in _BACKEND_TO_ID.items()}


def _pack_stream_list(streams: List[bytes]) -> bytes:
    out = bytearray()
    for s in streams:
        out += struct.pack("<I", len(s))
        out += s
    return bytes(out)


def _unpack_stream_list(buf: bytes, off: int, n: int) -> Tuple[List[bytes], int]:
    out = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + ln > len(buf):
            raise ValueError("truncated container")
        out.append(bytes(buf[off: off + ln]))
        off += ln
    return out, off


def serialize(enc: Dict[str, Any], entropy_backend: Optional[str] = None) -> bytes:
    """Pack an ``ELICCoder.compress`` result into one blob: TVC2 recording
    ``entropy_backend`` when it is given, TVC1 otherwise."""
    y_strings, z_strings = enc["strings"]
    num_slices, batch = len(y_strings), len(z_strings)
    zh, zw = enc["shape"]
    if entropy_backend is None:
        head = MAGIC + struct.pack("<HHHH", num_slices, batch, zh, zw)
    else:
        head = MAGIC2 + struct.pack("<HHHHB", num_slices, batch, zh, zw,
                                    _BACKEND_TO_ID[entropy_backend])
    body = _pack_stream_list(z_strings)
    for slice_streams in y_strings:
        for phase in slice_streams:  # [anchor, non_anchor]
            if len(phase) != batch:
                raise ValueError(f"a phase holds {len(phase)} streams for a batch of {batch}")
            body += _pack_stream_list(phase)
    return head + body


def deserialize(blob: bytes, expect_entropy_backend: Optional[str] = None) -> Dict[str, Any]:
    """Unpack into the ``{strings, shape}`` that ``ELICCoder.decompress`` takes.
    Raises ValueError if the recorded backend is not ``expect_entropy_backend``
    (TVC1 records none and is not checked)."""
    if blob[:4] == MAGIC:
        num_slices, batch, zh, zw = struct.unpack_from("<HHHH", blob, 4)
        off, backend = 12, None
    elif blob[:4] == MAGIC2:
        num_slices, batch, zh, zw, bid = struct.unpack_from("<HHHHB", blob, 4)
        off, backend = 13, _ID_TO_BACKEND.get(bid, f"unknown({bid})")
    else:
        raise ValueError("not a TVC1/TVC2 container")
    if (expect_entropy_backend is not None and backend is not None
            and backend != expect_entropy_backend):
        raise ValueError(
            f"container was coded with entropy_backend={backend!r} but the receiver runs "
            f"{expect_entropy_backend!r}; streams decode only with the backend that coded them")
    z_strings, off = _unpack_stream_list(blob, off, batch)
    y_strings = []
    for _ in range(num_slices):
        anchor, off = _unpack_stream_list(blob, off, batch)
        non_anchor, off = _unpack_stream_list(blob, off, batch)
        y_strings.append([anchor, non_anchor])
    if off != len(blob):
        raise ValueError("trailing bytes in container")
    return {"strings": [y_strings, z_strings], "shape": (zh, zw), "entropy_backend": backend}


def save(path: str, enc: Dict[str, Any], entropy_backend: Optional[str] = None) -> int:
    blob = serialize(enc, entropy_backend=entropy_backend)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def load(path: str, expect_entropy_backend: Optional[str] = None) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return deserialize(f.read(), expect_entropy_backend=expect_entropy_backend)
