"""Build and load the host codec (g++ -> .so, ctypes ABI).

``native/imgcodec.cc`` is compiled with ``g++ -O3 -shared -fPIC`` (no
``-march``: one library is right on any x86-64 host) into
``transhuman_tpu_torch/_build/libimgcodec.so`` on first use, never at
import, and rebuilt whenever the source or the flags change (a sha256 stamp
sits beside it).  Each C entry returns an error code and writes its message
into the caller's buffer; :func:`call` turns a failure into an exception.
A failed build raises: no decode path falls back to anything else.  ctypes
releases the GIL for the length of each call, so loader threads decode in
parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_HERE, "imgcodec.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libimgcodec.so")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # data, n, &height, &width, err, errlen
    "thc_jpeg_info": (_P, _L, _IP, _IP, ctypes.c_char_p, _I),
    # data, n, out, height, width, err, errlen
    "thc_jpeg_decode": (_P, _L, _P, _I, _I, ctypes.c_char_p, _I),
    # in, n, height, rowbytes, bpp, out, err, errlen
    "thc_png_unfilter": (_P, _L, _I, _L, _I, _P, ctypes.c_char_p, _I),
}

_lock = threading.Lock()
_lib = None


def _fingerprint() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile SOURCE into LIB_PATH (atomic replace); raise with g++'s
    output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        out = subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"building the image codec failed "
                               f"({out.returncode}):\n{out.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    with open(LIB_PATH + ".sha256", "w") as f:
        f.write(_fingerprint())
    return LIB_PATH


def _stale() -> bool:
    try:
        with open(LIB_PATH + ".sha256") as f:
            return f.read().strip() != _fingerprint()
    except OSError:
        return True


def library() -> ctypes.CDLL:
    """The codec library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale() or not os.path.exists(LIB_PATH):
                build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def loaded() -> bool:
    return _lib is not None


def call(name: str, *args, what: str = ""):
    """Call C entry ``name`` with ``args`` and its error buffer; raise
    ValueError (what: the message) on a non-zero code."""
    err = ctypes.create_string_buffer(256)
    code = getattr(library(), name)(*args, err, len(err))
    if code != 0:
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
