"""Minimal TensorBoard event-file writer (pure Python, no TensorFlow).

The reference logs scalars + learning rate to TENSORBOARD_PATH via keras'
TensorBoard callback (ref: src/utils/KerasCallbacks.py:167-174 LRTensorBoard).
This module hand-encodes the tfevents wire format — TFRecord framing with
masked CRC32C plus the Event/Summary protobuf messages — so training curves
remain viewable in standard TensorBoard without a TF dependency. The port's
own copy of ``cmrtpu/utils/tfevents.py``.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

from cmrtpu_torch.utils.io_utils import ensure_dir

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------
_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _crc = _i
    for _ in range(8):
        _crc = (_crc >> 1) ^ _POLY if _crc & 1 else _crc >> 1
    _TABLE.append(_crc)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire helpers
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(field: int, value: int) -> bytes:
    return _varint((field << 3) | 0) + _varint(value)


def _field_double(field: int, value: float) -> bytes:
    return _varint((field << 3) | 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _varint((field << 3) | 5) + struct.pack("<f", value)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    msg = _field_double(1, wall_time) + _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if summary is not None:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    value_msg = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, value_msg)


def encode_png_rgb(rgb) -> bytes:
    """Minimal 8-bit RGB PNG encoder (IHDR + one zlib IDAT + IEND). Avoids a
    TF/PIL dependency for TB image summaries; compression runs through the
    native cmrio core when available."""
    import zlib
    import numpy as np

    arr = np.ascontiguousarray(np.asarray(rgb, dtype=np.uint8))
    assert arr.ndim == 3 and arr.shape[2] == 3, "expect [H, W, 3] uint8"
    h, w = arr.shape[:2]
    # each scanline prefixed with filter byte 0
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    compressed = zlib.compress(raw, 6)

    def chunk(typ: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + typ + payload +
                struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", compressed) + chunk(b"IEND", b""))


def _image_summary(tag: str, rgb) -> bytes:
    """Summary.Value{tag, image{height(1), width(2), colorspace(3)=3,
    encoded_image_string(4)}} — image is Value field 4."""
    import numpy as np
    arr = np.asarray(rgb)
    image_msg = (_field_varint(1, arr.shape[0]) + _field_varint(2, arr.shape[1])
                 + _field_varint(3, 3) + _field_bytes(4, encode_png_rgb(arr)))
    value_msg = _field_bytes(1, tag.encode()) + _field_bytes(4, image_msg)
    return _field_bytes(1, value_msg)


class EventWriter:
    """Append-only tfevents file: ``add_scalar(tag, value, step)``."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        ensure_dir(log_dir)
        name = f"events.out.tfevents.{int(time.time())}.cmrtpu{filename_suffix}"
        self._path = os.path.join(log_dir, name)
        self._fh = open(self._path, "ab")
        self._write_record(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            _event(time.time(), step, summary=_scalar_summary(tag, value)))

    def add_image(self, tag: str, rgb, step: int) -> None:
        """[H, W, 3] uint8 image summary (ref CustomImageWritertf2 writes
        pred-vs-gt panels to TB, src/utils/KerasCallbacks.py:386-536)."""
        self._write_record(
            _event(time.time(), step, summary=_image_summary(tag, rgb)))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.flush()
        self._fh.close()
