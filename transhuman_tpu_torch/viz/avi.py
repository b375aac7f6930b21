"""MJPG-in-AVI video writer with the standard library and the port's own
JPEG encoder (a copy of transhuman_tpu/viz/avi.py, whose JPEGs come from
imageio; the card's machine has neither imageio nor OpenCV).

The reference assembles freeview/mesh videos with imageio's ffmpeg backend
(`gen_freeview_video.py:15-27`); where that is missing the JAX package, and
here always, a classic RIFF/AVI container holds per-frame JPEGs (fourcc
``MJPG``), which every mainstream player decodes.  The JPEGs are
``native/imgcodec.cc``'s baseline encoder: 4:2:0 at IJG quality 95, written
as libjpeg's default compression is (what ``cv2.imencode`` gives).

Container layout (all little-endian)::

    RIFF <size> 'AVI '
      LIST <size> 'hdrl'
        'avih' 56B   main header (frame period us, flags HASINDEX, dims)
        LIST <size> 'strl'
          'strh' 56B  stream header (fccType 'vids', handler 'MJPG',
                       rate/scale = fps/1, length = n_frames)
          'strf' 40B  BITMAPINFOHEADER (biCompression 'MJPG')
      LIST <size> 'movi'
        '00dc' <size> <jpeg bytes> [pad to even] ...   one per frame
      'idx1' <size>   16B per frame: '00dc', KEYFRAME, offset, size

Offsets in ``idx1`` follow the common convention: relative to the first
byte after the ``movi`` fourcc (first chunk is at offset 4).  Frame sizes
are not known up front, so chunks stream to the file and the three
back-patched size fields (RIFF, movi, avih/strh counts) are fixed up at
close time.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from ..native import build as codec

AVIF_HASINDEX = 0x00000010
AVIIF_KEYFRAME = 0x00000010


def to_rgb8(arr) -> np.ndarray:
    """(H, W, 3) uint8 of a uint8, uint16 (the high byte) or float in
    [0, 1] frame; a 2-D frame is replicated to three channels.  Other
    dtypes raise."""
    a = np.asarray(arr)
    if a.dtype == np.uint16:
        a = (a >> 8).astype(np.uint8)
    elif a.dtype != np.uint8:
        if not np.issubdtype(a.dtype, np.floating):
            raise ValueError(
                f"unsupported frame dtype {a.dtype}: pass uint8, uint16, "
                "or float in [0, 1]")
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, axis=-1)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"a frame is (H, W, 3) or (H, W); got {a.shape}")
    return np.ascontiguousarray(a)


def encode_jpeg(arr, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 / uint16 / float-in-[0,1] (or (H, W)) -> baseline
    4:2:0 JPEG bytes at the IJG ``quality``, through the port's codec."""
    a = to_rgb8(arr)
    out, n = ctypes.c_void_p(), ctypes.c_int64()
    codec.call("thc_jpeg_encode", a.ctypes.data, a.shape[0], a.shape[1],
               int(quality), ctypes.byref(out), ctypes.byref(n),
               what="JPEG encode")
    try:
        return ctypes.string_at(out.value, n.value)
    finally:
        codec.library().thc_free(out)


class MJPGWriter:
    """Streaming MJPG/AVI writer: append frames, close back-patches sizes."""

    def __init__(self, path: str, width: int, height: int, fps: int = 30,
                 quality: int = 95):
        self.path, self.w, self.h = path, int(width), int(height)
        self.fps, self.quality = int(fps), quality
        self._fh: Optional[object] = open(path, "wb")
        self._index = []  # (offset_in_movi, size) per frame
        self._max_chunk = 0
        self._write_headers(n_frames=0)  # placeholder counts, patched later
        self._movi_start = self._fh.tell()  # at the LIST size field
        self._fh.write(b"LIST" + struct.pack("<I", 0) + b"movi")

    # -- header block ----------------------------------------------------
    def _avih(self, n_frames: int) -> bytes:
        return b"avih" + struct.pack(
            "<IIIIIIIIIIIIII",
            56,
            1_000_000 // max(self.fps, 1),  # dwMicroSecPerFrame
            0, 0,                            # dwMaxBytesPerSec, padding
            AVIF_HASINDEX,
            n_frames, 0, 1,                  # total, initial, streams
            self._max_chunk,                 # dwSuggestedBufferSize
            self.w, self.h,
            0, 0, 0,                         # reserved (3 of 4; 4th below)
        ) + struct.pack("<I", 0)

    def _strl(self, n_frames: int) -> bytes:
        strh = b"strh" + struct.pack(
            "<I4s4sIHHIIIIIIII4H",
            56,
            b"vids", b"MJPG",
            0, 0, 0, 0,                      # flags, priority, lang, init
            1, max(self.fps, 1),             # dwScale / dwRate = frame rate
            0, n_frames,                     # start, length
            self._max_chunk,                 # suggested buffer
            0xFFFFFFFF, 0,                   # quality (-1), sample size
            0, 0, self.w & 0xFFFF, self.h & 0xFFFF,  # rcFrame l,t,r,b
        )
        strf = b"strf" + struct.pack(
            "<IIiiHH4sIiiII",
            40,
            40,                              # biSize (BITMAPINFOHEADER)
            self.w, self.h, 1, 24,
            b"MJPG",
            self.w * self.h * 3,
            0, 0, 0, 0,
        )
        body = strh + strf
        return b"LIST" + struct.pack("<I", 4 + len(body)) + b"strl" + body

    def _write_headers(self, n_frames: int):
        hdrl_body = self._avih(n_frames) + self._strl(n_frames)
        self._fh.write(b"RIFF" + struct.pack("<I", 0) + b"AVI ")
        self._fh.write(b"LIST" + struct.pack("<I", 4 + len(hdrl_body))
                       + b"hdrl" + hdrl_body)

    # -- frames ------------------------------------------------------------
    def append(self, frame):
        """Append one (H, W, 3) frame (uint8/uint16 or float in [0, 1])."""
        fh, fw = np.asarray(frame).shape[:2]
        if (fh, fw) != (self.h, self.w):
            # the header declares frame-0 dims; a mismatched frame would
            # write silently and garble strict players at playback time
            raise ValueError(
                f"frame is {fh}x{fw} but the stream was opened as "
                f"{self.h}x{self.w} (AVI streams are fixed-size; resize or "
                "pad frames before appending)"
            )
        jpg = encode_jpeg(frame, self.quality)
        # idx1 offsets are relative to the 'movi' fourcc (first chunk -> 4)
        off = self._fh.tell() - self._movi_start - 8
        if off + len(jpg) + len(self._index) * 16 > 0xFFFF0000:
            # 32-bit RIFF size fields: crossing 4 GiB would only fail at
            # close(), AFTER all the encoding work, leaving an unplayable
            # placeholder-header file
            raise ValueError(
                "AVI output would exceed the container's 4 GiB limit; "
                "lower quality/fps or split the sequence"
            )
        self._index.append((off, len(jpg)))
        self._max_chunk = max(self._max_chunk, len(jpg))
        self._fh.write(b"00dc" + struct.pack("<I", len(jpg)) + jpg)
        if len(jpg) & 1:
            self._fh.write(b"\x00")  # RIFF chunks are 2-byte aligned

    # -- finalize ------------------------------------------------------------
    def close(self):
        if self._fh is None:
            return
        movi_end = self._fh.tell()
        idx = b"".join(
            b"00dc" + struct.pack("<III", AVIIF_KEYFRAME, off, size)
            for off, size in self._index
        )
        self._fh.write(b"idx1" + struct.pack("<I", len(idx)) + idx)
        riff_end = self._fh.tell()
        # back-patch: movi LIST size, RIFF size, then regenerate the header
        # block in place (same length — only counts/buffer sizes change)
        self._fh.seek(self._movi_start + 4)
        self._fh.write(struct.pack("<I", movi_end - self._movi_start - 8))
        self._fh.seek(0)
        self._write_headers(n_frames=len(self._index))
        self._fh.seek(4)
        self._fh.write(struct.pack("<I", riff_end - 8))
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
