"""TensorBoard event files with the standard library alone (the port's copy
of transhuman_tpu/utils/tb_writer.py; images are PNG-encoded by the port's
``utils/png.py``, since the card's machine has no imageio).

* file: ``events.out.tfevents.<wall_time>.<hostname>.<pid>.<uid>`` of
  TFRecords: ``uint64 len | uint32 masked_crc32c(len) | data |
  uint32 masked_crc32c(data)``;
* payload: an ``Event`` protobuf (wall_time=1 double, step=2 int64,
  file_version=3 string, summary=5 message); ``Summary`` holds repeated
  ``Value`` (tag=1 string, simple_value=2 float, image=4 message); an image
  is height/width/colorspace varints and PNG bytes (field 4).

CRC32C (Castagnoli) is table-driven Python: the JAX package's native
``crc32c.cc`` speed-up for large image records is not carried.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        tab = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord CRC masking (kMaskDelta rotation)."""
    c = crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    if n < 0:
        n &= (1 << 64) - 1  # int64 as 10-byte two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _pb_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _pb_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _encode_image(arr) -> bytes:
    """Summary.Image message from an (H, W[, C]) uint8 or [0, 1] array."""
    import numpy as np

    from .png import encode_png

    a = np.asarray(arr)
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]
    return (_pb_varint(1, h) + _pb_varint(2, w)
            + _pb_varint(3, c)  # colorspace: 1=gray, 3=rgb, 4=rgba
            + _pb_bytes(4, encode_png(a)))


def _event(step: int, summary: bytes = b"", file_version: str = "") -> bytes:
    msg = _pb_double(1, time.time()) + _pb_varint(2, step)
    if file_version:
        msg += _pb_bytes(3, file_version.encode())
    if summary:
        msg += _pb_bytes(5, summary)
    return msg


class TBWriter:
    """Append-only scalar/image event stream (tensorboardX SummaryWriter's
    add_scalar and add_image)."""

    _uid = 0

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        # pid and a per-process uid in the name: two writers opened in the
        # same second in one log_dir get files of their own
        TBWriter._uid += 1
        name = "events.out.tfevents.%010d.%s.%d.%d%s" % (
            int(time.time()), socket.gethostname(), os.getpid(),
            TBWriter._uid, filename_suffix)
        self.path = os.path.join(log_dir, name)
        self._fh: Optional[object] = open(self.path, "ab")
        self._write_record(_event(0, file_version="brain.Event:2"))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", masked_crc32c(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", masked_crc32c(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        v = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
        self._write_record(_event(step, summary=_pb_bytes(1, v)))

    def add_scalars(self, scalars: dict, step: int):
        summary = b"".join(
            _pb_bytes(1, _pb_bytes(1, t.encode()) + _pb_float(2, float(v)))
            for t, v in scalars.items())
        self._write_record(_event(step, summary=summary))

    def add_image(self, tag: str, image, step: int):
        v = _pb_bytes(1, tag.encode()) + _pb_bytes(4, _encode_image(image))
        self._write_record(_event(step, summary=_pb_bytes(1, v)))

    def flush(self):
        if self._fh:
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
