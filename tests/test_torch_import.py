"""The PyTorch port imports without JAX, without the JAX package, and
without building a kernel.

Runs in a subprocess: this test process has imported jax already (conftest).
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, subprocess, sys

def _no_process(*a, **k):
    raise RuntimeError("a process was started at import: %r" % (a[:1],))

subprocess.Popen = _no_process  # a kernel build would run nvcc here
import transhuman_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from transhuman_tpu_torch.kernels import build
print(json.dumps({
    "modules": mods,
    "loaded": sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "flax", "optax", "triton",
                                            "transhuman_tpu", "cv2", "yaml")),
    "lib_loaded": build.loaded(),
}))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_import_loads_no_jax_and_no_jax_package(probe):
    # every submodule was imported, and none pulled in JAX, Flax, Optax,
    # the JAX package itself, or a module the GPU machine lacks
    assert len(probe["modules"]) >= 25
    assert probe["loaded"] == []


def test_import_builds_no_kernel(probe):
    assert probe["lib_loaded"] is False


def test_package_source_has_no_jax_import():
    pkg = os.path.join(ROOT, "transhuman_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                for line in fh:
                    s = line.strip()
                    if s.startswith(("import jax", "from jax", "import flax",
                                     "from flax", "import optax")):
                        offenders.append(f"{path}: {s}")
    assert offenders == []
