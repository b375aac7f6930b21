"""Build and load the port's host C++ libraries (g++ -> .so, ctypes ABI).

Each library is one source of this directory, compiled with ``g++ -O3
-std=c++17 -shared -fPIC`` (no ``-march``: one library is right on any
x86-64 host) plus the flags ``LIBRARIES`` names beside its source, into
``transhuman_tpu_torch/_build/lib<name>.so`` on first use, never at import:

* ``imgcodec`` (``imgcodec.cc``): the JPEG decoder (sequential and
  progressive) and encoder, the EXIF orientation, the PNG row unfilter,
  BMP RLE4/RLE8 and TIFF PackBits and LZW;
* ``marching`` (``marching_tet.cc``): marching tetrahedra
  (``mesh_ops/marching.py``);
* ``crc32c`` (``crc32c.cc``): the event files' CRC32C
  (``utils/tb_writer.py``), with ``-msse4.2`` on x86-64 for the CRC32
  instruction (the slicing-by-8 tables elsewhere);
* ``rasterize`` (``rasterize.cc``): the mesh video's z-buffer
  (``viz/mesh_render.py``), with ``-mfma`` on an x86-64 host whose CPU has
  fused multiply-adds, as the JAX package's ``-march=native`` build has
  them.

A library is rebuilt whenever its source, its flags or the compiler change
(a sha256 stamp sits beside it, written atomically); one lock guards every
build and load in a process, a file lock beside each library
(``lib<name>.so.lock``) guards its stale check, build and stamp across
processes, so ranks started together build it once, and a build writes a
process-unique file that replaces the library atomically.  A failed build
raises with the compiler's output: no caller falls back to anything else.  Each codec entry returns an error code and
writes its message into the caller's buffer; :func:`call` turns a failure
into an exception.  ctypes releases the GIL for the length of each call, so
loader threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import subprocess
import threading

from ..utils.filelock import file_lock, write_atomic

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_X86 = platform.machine().lower() in ("x86_64", "amd64")


def _cpu_has(flag: str) -> bool:
    try:
        with open("/proc/cpuinfo") as f:
            return bool(re.search(rf"^flags\s*:.*\b{flag}\b", f.read(),
                                  re.M))
    except OSError:
        return False


# name -> (source in this directory, flags beyond FLAGS).  The rasterizer's
# frames equal the JAX package's (built with -march=native) bit for bit
# only where both contract a * b + c into the same fused multiply-adds:
# -mfma on a host whose CPU has them.
LIBRARIES = {
    "imgcodec": ("imgcodec.cc", ()),
    "marching": ("marching_tet.cc", ()),
    "crc32c": ("crc32c.cc", ("-msse4.2",) if _X86 else ()),
    "rasterize": ("rasterize.cc",
                  ("-mfma",) if _X86 and _cpu_has("fma") else ()),
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_IP = ctypes.POINTER(ctypes.c_int)
_ERR = (ctypes.c_char_p, _I)
# name -> {C entry: (argtypes, restype)}
_SIGNATURES = {
    "imgcodec": {
        # data, n, &height, &width, err, errlen
        "thc_jpeg_info": ((_P, _L, _IP, _IP, *_ERR), _I),
        # data, n, out, height, width, err, errlen
        "thc_jpeg_decode": ((_P, _L, _P, _I, _I, *_ERR), _I),
        # tiff, n -> orientation (-1: none)
        "thc_exif_orientation": ((_P, _L), _I),
        # src, height, width, orientation, dst
        "thc_orient_rgb": ((_P, _I, _I, _I, _P), None),
        # in, n, height, rowbytes, bpp, out, err, errlen
        "thc_png_unfilter": ((_P, _L, _I, _L, _I, _P, *_ERR), _I),
        # rgb, height, width, quality, &out, &n, err, errlen
        "thc_jpeg_encode": ((_P, _I, _I, _I, ctypes.POINTER(_P),
                             ctypes.POINTER(_L), *_ERR), _I),
        # in, n, bits, height, width, out, err, errlen
        "thc_bmp_rle": ((_P, _L, _I, _I, _I, _P, *_ERR), _I),
        # in, n, out, nout, err, errlen
        "thc_packbits": ((_P, _L, _P, _L, *_ERR), _I),
        "thc_tiff_lzw": ((_P, _L, _P, _L, *_ERR), _I),
        "thc_free": ((_P,), None),
    },
    "marching": {
        # grid, nx, ny, nz, threshold, &verts, &n_verts, &tris, &n_tris
        "mt_march": ((_P, _L, _L, _L, ctypes.c_float, ctypes.POINTER(_P),
                      ctypes.POINTER(_L), ctypes.POINTER(_P),
                      ctypes.POINTER(_L)), _I),
        "mt_free": ((_P, _P), None),
    },
    "crc32c": {
        "crc32c_raw": ((_P, ctypes.c_size_t), ctypes.c_uint32),
    },
    "rasterize": {
        # verts, nv, tris, nt, K, R, T, H, W, out_rgb, out_depth
        "rz_render": ((_P, _L, _P, _L, _P, _P, _P, _L, _L, _P, _P), _I),
    },
}

_lock = threading.Lock()
_libs: dict = {}


def lib_path(name: str = "imgcodec") -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _command(name: str, out: str) -> list:
    source, extra = LIBRARIES[name]
    return [CXX, *FLAGS, *extra, os.path.join(_HERE, source), "-o", out]


def _fingerprint(name: str) -> str:
    h = hashlib.sha256(" ".join(_command(name, "")).encode())
    with open(os.path.join(_HERE, LIBRARIES[name][0]), "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def build(name: str = "imgcodec") -> str:
    """Compile library ``name`` into lib_path(name) (atomic replace) under
    its file lock; raise RuntimeError with the compiler's output on
    failure."""
    with file_lock(lib_path(name) + ".lock"):
        return _build(name)


def _build(name: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = lib_path(name)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        try:
            out = subprocess.run(_command(name, tmp), capture_output=True,
                                 text=True)
        except OSError as e:
            raise RuntimeError(f"building lib{name}.so failed: {e}") from e
        if out.returncode != 0:
            raise RuntimeError(f"building lib{name}.so failed "
                               f"({out.returncode}):\n{out.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    write_atomic(path + ".sha256", _fingerprint(name))
    return path


def _stale(name: str) -> bool:
    try:
        with open(lib_path(name) + ".sha256") as f:
            return f.read().strip() != _fingerprint(name)
    except OSError:
        return True


def library(name: str = "imgcodec") -> ctypes.CDLL:
    """Library ``name``, built first if missing or stale."""
    with _lock:
        if name not in _libs:
            with file_lock(lib_path(name) + ".lock"):
                if _stale(name) or not os.path.exists(lib_path(name)):
                    _build(name)
                lib = ctypes.CDLL(lib_path(name))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return _libs[name]


def loaded(name: str = "imgcodec") -> bool:
    return name in _libs


def call(name: str, *args, what: str = ""):
    """Call the codec's C entry ``name`` with ``args`` and its error
    buffer; raise ValueError (what: the message) on a non-zero code."""
    err = ctypes.create_string_buffer(256)
    code = getattr(library(), name)(*args, err, len(err))
    if code != 0:
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
