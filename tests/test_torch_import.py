"""The PyTorch port imports without JAX, without the JAX package, and
without building a kernel.

Runs in a subprocess: this test process has imported jax already (conftest).
"""

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, subprocess, sys

def _no_process(*a, **k):
    raise RuntimeError("a process was started at import: %r" % (a[:1],))

class _Blocked:
    # the JAX package, JAX, PyYAML, OpenCV, imageio, PIL and torchvision are
    # not importable, as on the GPU machine
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "flax", "optax", "transhuman_tpu",
                                  "yaml", "cv2", "imageio", "PIL",
                                  "torchvision"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, _Blocked())
_popen = subprocess.Popen
subprocess.Popen = _no_process  # a kernel build would run nvcc here
import transhuman_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.kernels import build
from transhuman_tpu_torch.models.network import TransHumanNet
net = TransHumanNet(embed_dim=24, vit_depth=1, vit_heads=2, knn_k=4)
tree = weights.jax_params_from_state_dict(net.state_dict())["params"]
back = weights.live_state_dict(weights.state_dict_from_jax(tree, 1))
from transhuman_tpu_torch.native import build as codec
codec_loaded = codec.loaded()
# decoding builds the host codec with g++: processes may start from here
subprocess.Popen = _popen
import hashlib, os
from transhuman_tpu_torch.data import image_io, zju
fix = os.path.join("tests", "fixtures", "torch_zju")
digests = json.load(open(os.path.join(fix, "digests.json")))
decoded = {}
for name in ("cv2_q95_420.jpg", "mask_palette.png"):
    path = os.path.join(fix, name)
    img = (image_io.imread_rgb(path) if name.endswith(".jpg")
           else image_io.read_png(path))
    decoded[name] = hashlib.sha256(img.tobytes()).hexdigest() == digests[
        name]["sha256"]
# the video writer and the mesh video, through the port's PNG, JPEG,
# rasterizer and AVI code alone
import tempfile
import numpy as np
from transhuman_tpu_torch.mesh_ops import marching
from transhuman_tpu_torch.mesh_ops.ply import save_ply
from transhuman_tpu_torch.utils.png import write_png
from transhuman_tpu_torch.viz import mesh_render, video
tmp = tempfile.mkdtemp()
for i in range(3):
    write_png(os.path.join(tmp, "frame%04d.png" % i),
              np.full((16, 24, 3), 0.3 * i, np.float32))
avi = video.frames_to_video(tmp, os.path.join(tmp, "h.mp4"))
g = np.arange(12, dtype=np.float32)
x, y, z = np.meshgrid(g, g, g, indexing="ij")
verts, tris = marching.marching_tetrahedra(
    4 - np.sqrt((x - 5.5) ** 2 + (y - 5.5) ** 2 + (z - 5.5) ** 2), 0.0)
save_ply(os.path.join(tmp, "m.ply"), (verts - 5.5) / 4, tris)
K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
w2c = np.eye(4, dtype=np.float32)
w2c[2, 3] = 3.0
pngs = mesh_render.render_mesh_sequence([os.path.join(tmp, "m.ply")], K,
                                        [w2c], (32, 32),
                                        os.path.join(tmp, "mesh"))
video_run = {"avi": os.path.basename(avi), "avi_bytes": os.path.getsize(avi),
             "mesh_frame_lit": int(image_io.read_png(pngs[0]).any(-1).sum())}
print(json.dumps({
    "video_run": video_run,
    "codec_loaded_at_import": codec_loaded,
    "decoded": decoded,
    "modules": mods,
    "loaded": sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "flax", "optax", "triton",
                                            "transhuman_tpu", "cv2", "yaml",
                                            "imageio", "PIL", "torchvision")),
    "lib_loaded": build.loaded(),
    "bridge_roundtrip": back.keys() == net.state_dict().keys() and all(
        bool((back[k] == v).all()) for k, v in net.state_dict().items()),
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
    assert probe["codec_loaded_at_import"] is False


def test_zju_loader_decodes_without_cv2_pil_or_imageio(probe):
    """Under the block, data.zju imports and the codec (built on first use)
    decodes a fixture JPEG and a palette PNG to cv2's and imageio's bytes."""
    assert probe["decoded"] == {"cv2_q95_420.jpg": True,
                                "mask_palette.png": True}


def test_video_and_mesh_video_run_without_cv2_pil_or_imageio(probe):
    """Under the block, frames_to_video writes an AVI of PNG frames and the
    mesh video's rasterizer renders a marched sphere into a PNG."""
    run = probe["video_run"]
    assert run["avi"] == "h.avi" and run["avi_bytes"] > 3 * 600
    assert run["mesh_frame_lit"] > 50


def test_weights_bridge_runs_without_the_jax_package(probe):
    """state_dict_from_jax and jax_params_from_state_dict round-trip a
    model's weights with JAX and the JAX package unimportable."""
    assert probe["bridge_roundtrip"] is True


_FOREIGN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|transhuman_tpu)(\.|\s|$)")


def test_package_source_has_no_jax_import():
    """No line of the port or of chip_smoke.py imports JAX, Flax, Optax or
    the JAX package (transhuman_tpu_torch itself is fine), at top level or
    indented inside a function."""
    pkg = os.path.join(ROOT, "transhuman_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            for line in fh:
                if _FOREIGN_IMPORT.match(line):
                    offenders.append(f"{path}: {line.strip()}")
    assert len(paths) > 30
    assert offenders == []
    for bad in ("    from transhuman_tpu.tools import x", "import jax.numpy",
                "from transhuman_tpu import config", "import transhuman_tpu"):
        assert _FOREIGN_IMPORT.match(bad), bad
    assert not _FOREIGN_IMPORT.match("from transhuman_tpu_torch import x")


NEW_MODULES = {
    "transhuman_tpu_torch.config", "transhuman_tpu_torch.models.lpips",
    "transhuman_tpu_torch.utils.yaml_subset",
    "transhuman_tpu_torch.utils.recorder",
    "transhuman_tpu_torch.utils.tb_writer",
    "transhuman_tpu_torch.tools.convert_lpips",
    "transhuman_tpu_torch.tools.convert_resnet",
    "transhuman_tpu_torch.train.checkpoint",
    "transhuman_tpu_torch.data.loader", "transhuman_tpu_torch.cli.common",
    "transhuman_tpu_torch.cli.train", "transhuman_tpu_torch.data.zju",
    "transhuman_tpu_torch.data.image_io", "transhuman_tpu_torch.data.imgproc",
    "transhuman_tpu_torch.native.build", "transhuman_tpu_torch.viz.avi",
    "transhuman_tpu_torch.viz.video", "transhuman_tpu_torch.viz.mesh_render",
    "transhuman_tpu_torch.tools.render_mesh_video",
    "transhuman_tpu_torch.parallel", "transhuman_tpu_torch.parallel.mesh",
    "transhuman_tpu_torch.utils.filelock",
    "transhuman_tpu_torch.parallel.infer", "transhuman_tpu_torch.registry",
    "transhuman_tpu_torch.utils.debug",
    "transhuman_tpu_torch.tools.make_kmeans",
    "transhuman_tpu_torch.tools.data_fixes",
    "transhuman_tpu_torch.tools.doctor",
    "transhuman_tpu_torch.tools.validate_official",
    "transhuman_tpu_torch.parallel.tp", "transhuman_tpu_torch.parallel.pp",
    "transhuman_tpu_torch.utils.profiling",
}


def test_config_lpips_and_lifecycle_modules_import_alone(probe):
    """The config reader, LPIPS, the converters, the checkpoints, the
    Recorder and its event writer, the ray-sharded render, the registries
    and the tools import with JAX, the JAX package, PyYAML, OpenCV and
    imageio all unimportable."""
    assert NEW_MODULES <= set(probe["modules"]) | {"transhuman_tpu_torch"}


_HOST_ONLY = re.compile(
    r"^\s*(import|from)\s+(yaml|cv2|imageio|PIL|torchvision)(\.|\s|$)")


def test_package_source_imports_no_yaml_cv2_or_imageio():
    pkg = os.path.join(ROOT, "transhuman_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    offenders += [f"{f}: {line.strip()}" for line in fh
                                  if _HOST_ONLY.match(line)]
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        offenders += [line.strip() for line in fh if _HOST_ONLY.match(line)]
    assert offenders == []
