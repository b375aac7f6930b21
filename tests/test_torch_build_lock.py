"""Processes started together on a missing library (the ranks of one
torchrun) build it once and load the same file: the host C++ libraries
(native/build.py, with g++) and the CUDA kernel library
(kernels/build.py, with a stand-in nvcc that logs its calls and links a
stub of the C entries with g++, since this machine has no nvcc).  Each
compiler call is logged; a sleep widens the window in which two builds
would overlap without the lock."""

import json
import os
import stat
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 3

_NATIVE = r"""
import json, os, sys, ctypes
from transhuman_tpu_torch.native import build as b
b.BUILD_DIR, b.CXX = sys.argv[1], sys.argv[2]
lib = b.library("crc32c")
st = os.stat(b.lib_path("crc32c"))
print(json.dumps({"lib": [st.st_ino, st.st_mtime_ns],
                  "crc": lib.crc32c_raw(b"123456789", 9)}))
"""

_KERNELS = r"""
import json, os, sys
from transhuman_tpu_torch.kernels import build as b
b.BUILD_DIR = sys.argv[1]
b.LIB_PATH = os.path.join(b.BUILD_DIR, "libkernels.so")
b.LOCK_PATH = b.LIB_PATH + ".lock"
lib = b.library()
st = os.stat(b.LIB_PATH)
stamp = open(b.LIB_PATH + ".sha256").read()
print(json.dumps({"lib": [st.st_ino, st.st_mtime_ns],
                  "ok": lib.thp_min_excess2(None, None, None, None, 0, 0,
                                            None) == 0,
                  "stamp": stamp == b._fingerprint()}))
"""


def _script(path, body):
    with open(path, "w") as f:
        f.write(body)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


def _run_together(code, args, env):
    procs = [subprocess.Popen([sys.executable, "-c", code, *args], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(N_PROCS)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    return outs


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, **extra)
    return env


def test_host_library_builds_once_across_processes(tmp_path):
    log = tmp_path / "cxx.log"
    cxx = tmp_path / "cxx"
    _script(cxx, f"#!/bin/sh\necho \"$@\" >> {log}\nsleep 1\n"
                 "exec g++ \"$@\"\n")
    build_dir = tmp_path / "_build"
    outs = _run_together(_NATIVE, [str(build_dir), str(cxx)], _env())
    assert len(log.read_text().splitlines()) == 1
    assert len({tuple(o["lib"]) for o in outs}) == 1
    assert all(o["crc"] == 0xE3069283 for o in outs)  # CRC-32C check value
    assert not [p for p in os.listdir(build_dir) if p.endswith(".tmp")]


def test_kernel_library_builds_once_across_processes(tmp_path):
    """One nvcc per source, then one link, however many processes start:
    the compile and link commands appear once each in the log."""
    from transhuman_tpu_torch.kernels import build

    stub = tmp_path / "stub.c"
    stub.write_text("".join(f"int {name}(void) {{ return 0; }}\n"
                            for name in build._SIGNATURES))
    log = tmp_path / "nvcc.log"
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    # a compile touches its object; the link builds the stub library
    _script(bindir / "nvcc", f"""#!/bin/sh
echo "$@" >> {log}
sleep 1
out=""; shared=0; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  [ "$a" = "-shared" ] && shared=1
  prev="$a"
done
if [ $shared = 1 ]; then exec g++ -x c -shared -fPIC -o "$out" {stub}; fi
: > "$out"
""")
    build_dir = tmp_path / "_build"
    env = _env(CUDA_HOME=str(tmp_path / "cuda"),
               PATH=f"{bindir}:{os.environ.get('PATH', '')}")
    outs = _run_together(_KERNELS, [str(build_dir)], env)
    calls = log.read_text().splitlines()
    assert len(calls) == len(build.sources()) + 1, calls
    assert sum("-shared" in c for c in calls) == 1
    assert len({tuple(o["lib"]) for o in outs}) == 1
    assert all(o["ok"] and o["stamp"] for o in outs)
    assert not [p for p in os.listdir(build_dir) if p.endswith(".tmp")]
