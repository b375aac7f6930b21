"""Build and load the hand-written CUDA kernels (nvcc -> .so, ctypes ABI).

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) by its own nvcc
process, all started together, and the objects are linked into
``transhuman_tpu_torch/_build/libkernels.so``; the sources have a plain C
interface and no PyTorch headers, so the build takes seconds.  The
library is built on first use, never at import, and rebuilt whenever the
sources or flags change (a sha256 stamp sits beside it).  Each C entry takes
raw device pointers and the CUDA stream as ``void*`` and returns an error
code, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkernels.so")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # pts, refs, bias2, out, n, m, stream
    "thp_min_excess2": ((_P, _P, _P, _P, _I, _I, _P), _I),
    # pts, centers, rot, tokens, tok, pe, dist, idx, w, n, c, v, d, k,
    # n_freqs, alpha, stream
    "thp_dparf": ((_P,) * 9 + (_I,) * 6 + (_F, _P), _I),
    # as thp_dparf, tokens and tok bfloat16
    "thp_dparf_bf16": ((_P,) * 9 + (_I,) * 6 + (_F, _P), _I),
    # ids_sorted, seg_end, order, g, w4, seg_start, ranges, sums, out, v, n,
    # c, hw, dx, dy, nseg, seg, stream
    "thp_dfeat_scatter": ((_P,) * 9 + (_I,) * 8 + (_P,), _I),
    # as thp_dfeat_scatter, g and out bfloat16
    "thp_dfeat_scatter_bf16": ((_P,) * 9 + (_I,) * 8 + (_P,), _I),
    # src, ids, w, out, v, n, c, hw, t, off0, off1, off2, off3, stream
    "thp_feature_gather": ((_P,) * 4 + (_I,) * 9 + (_P,), _I),
    # src, uv, out, v, n, c, hf, wf, sx, sy, stream
    "thp_feature_sample": ((_P,) * 3 + (_I,) * 5 + (_F,) * 2 + (_P,), _I),
    # as thp_feature_sample, src and out bfloat16
    "thp_feature_sample_bf16": ((_P,) * 3 + (_I,) * 5 + (_F,) * 2 + (_P,),
                                _I),
    "thp_error_string": ((_I,), ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None  # the loaded CDLL; dlopen is process-wide, so is this


@dataclass
class BuildResult:
    path: str
    seconds: float
    log: str  # nvcc's output, including ptxas' register and spill report


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _fingerprint() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        shutil.which("nvcc"),
        os.path.join(home, "bin", "nvcc") if home else None,
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of transhuman_tpu_torch cannot be built"
    )


def _run(cmds):
    """Run the commands in parallel; raise with the output of any failure.
    Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]  # waits for every process
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> BuildResult:
    """Compile every csrc/*.cu (one nvcc each, in parallel) and link them
    into LIB_PATH (atomic replace)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
            for src in sources()]
    tmp = f"{LIB_PATH}.{tag}"
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                    for obj, src in zip(objs, sources())])
        log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, LIB_PATH)
    finally:
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.remove(path)
    with open(LIB_PATH + ".sha256", "w") as f:
        f.write(_fingerprint())
    return BuildResult(LIB_PATH, time.perf_counter() - t0, log)


def _stale() -> bool:
    try:
        with open(LIB_PATH + ".sha256") as f:
            return f.read().strip() != _fingerprint()
    except OSError:
        return True


def library() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale() or not os.path.exists(LIB_PATH):
                build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def loaded() -> bool:
    return _lib is not None


def check_tensors(name: str, dtypes=None, **tensors):
    """Raise unless every tensor is contiguous, on one CUDA device, and of
    its allowed dtype: ``dtypes`` maps an argument name to its dtype, and
    every other argument must be float32 (a wrong dtype is a TypeError).
    The C entries take raw pointers and trust them."""
    import torch

    dtypes = dtypes or {}
    dev = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        want = dtypes.get(arg, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: all tensors must share one device")
        dev = t.device


def check(code: int, what: str):
    """Raise if a C entry returned an error code."""
    if code != 0:
        msg = library().thp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA kernel failed ({code}): {msg}")

