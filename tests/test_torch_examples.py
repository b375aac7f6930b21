"""The port's examples (examples/torch_*.py) and launchers
(scripts/torch/*.sh) on the CPU, and the library constructors' explicit
device.

Each example runs as a user runs it, in a subprocess at a small shape with
``--device cpu``, and must exit 0 having passed its own check; the
pipelined vit_base TransHE runs over 2 gloo ranks under torchrun at depth
2 with vit_base's widths.  Each launcher passes ``sh -n``; run with a
stand-in ``python`` on PATH that records its arguments, each hands the
entry point an argv whose overrides merge onto its --cfg_file through the
port's own parser with no unknown key, and each returns the entry point's
exit code.
"""

import math
import os
import re
import subprocess
import sys

import pytest
import torch

from transhuman_tpu_torch.cli import common
from transhuman_tpu_torch.cli import run as run_cli
from transhuman_tpu_torch.data import image_io
from transhuman_tpu_torch.render.pipeline import RenderPipeline
from transhuman_tpu_torch.testing import synthetic_setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
SCRIPTS = os.path.join(ROOT, "scripts", "torch")
LAUNCHERS = ["train", "test", "video", "mesh"]
TIMEOUT = 240


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "XLA_FLAGS", "PYTHONPATH")}
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run(args, cwd):
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_minimal_render_example_writes_its_png(tmp_path):
    png = tmp_path / "render.png"
    out = _run([os.path.join(EXAMPLES, "torch_minimal_render.py"), str(png),
                "--device", "cpu", "--rays", "256"], tmp_path)
    assert re.search(r"wrote .*render\.png  \(16x16, mean acc [0-9.]+, "
                     r"decoded \d+ of 4096 points\)", out), out
    img = image_io.read_png(str(png))
    assert img.shape == (16, 16, 3) and img.dtype.name == "uint8"


def test_minimal_train_example_takes_finite_steps(tmp_path):
    out = _run([os.path.join(EXAMPLES, "torch_minimal_train.py"), "3",
                "--device", "cpu"], tmp_path)
    losses = [float(v) for v in re.findall(r"  loss: ([-0-9.naif]+)", out)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses), out
    assert "done [cpu]" in out


def test_pp_vit_base_example_over_two_gloo_ranks(tmp_path):
    """vit_base widths (768, 12 heads) at depth 2, 2 stages, 2
    microbatches: the example's own check (forward 1e-5, gradients 2e-6
    against the unsharded module) passes on both ranks."""
    out = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2",
                os.path.join(EXAMPLES, "torch_pp_vit_base.py"), "--device",
                "cpu", "--depth", "2", "--tokens", "16", "--batch", "4",
                "--micro", "2"], tmp_path)
    assert "vit_base TransHE: 56.7 MB of params, depth 2, 2 pipeline " \
           "stages [cpu]" in out, out
    for r in range(2):
        assert f"OK rank {r}: pipelined vit_base" in out, out


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launchers_pass_sh_n(name):
    subprocess.run(["sh", "-n", os.path.join(SCRIPTS, f"{name}.sh")],
                   check=True)


STAND_IN = """#!/bin/sh
# records its argv (one line each) and exits with $FAKE_RC
if [ "$1" = "-c" ]; then echo 2; exit 0; fi
for a in "$@"; do printf '%s\\n' "$a"; done > "$ARGV_FILE"
exit "${FAKE_RC:-0}"
"""


def _launch(name, tmp_path, rc=0, args=()):
    """Run scripts/torch/<name>.sh with the stand-in python: (its exit
    code, the argv the entry point's python got)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    (bin_dir / "python").write_text(STAND_IN)
    (bin_dir / "python").chmod(0o755)
    env = dict(_env(), PATH=f"{bin_dir}:{os.environ['PATH']}",
               ARGV_FILE=str(tmp_path / "argv.txt"), FAKE_RC=str(rc))
    env.pop("NPROC", None)
    p = subprocess.run(["sh", os.path.join(SCRIPTS, f"{name}.sh"), *args],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=60)
    return p.returncode, (tmp_path / "argv.txt").read_text().splitlines()


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_overrides_parse_and_exit_codes_propagate(name, tmp_path,
                                                           monkeypatch):
    args = {"train": ["my_run"], "test": ["1", "7", "exp"],
            "video": ["0", "7", "exp"], "mesh": ["0", "7", "exp"]}[name]
    rc, argv = _launch(name, tmp_path, 0, args)
    assert rc == 0, argv
    at = len(argv) - 1 - argv[::-1].index("-m")  # the entry point's -m
    module, entry = argv[at + 1], argv[at + 2:]
    if name == "train":
        # torchrun over every visible card (the stand-in says 2)
        assert argv[:5] == ["-m", "torch.distributed.run", "--standalone",
                            "--nproc_per_node", "2"]
        assert module == "transhuman_tpu_torch.cli.train"
    else:
        assert module == "transhuman_tpu_torch.cli.run"
        assert entry[:2] == ["--type", {"test": "evaluate",
                                        "video": "visualize",
                                        "mesh": "reconstruction"}[name]]
    monkeypatch.chdir(ROOT)
    parsed, cfg = common.parse_args(entry, need_type=name != "train",
                                    allow_test=name == "train")
    assert cfg.exp_name == ("my_run" if name == "train" else "exp")
    assert os.path.isfile(os.path.join(ROOT, parsed.cfg_file))
    if name != "train":
        assert cfg.test.epoch == 7
    # the entry point's failure is the script's
    rc, _ = _launch(name, tmp_path, 3, args)
    assert rc == 3


def test_test_launcher_takes_its_card_argument(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "python").write_text(
        '#!/bin/sh\necho "$CUDA_VISIBLE_DEVICES" > "$ARGV_FILE"\n')
    (bin_dir / "python").chmod(0o755)
    env = dict(_env(), PATH=f"{bin_dir}:{os.environ['PATH']}",
               ARGV_FILE=str(tmp_path / "cards.txt"))
    subprocess.run(["sh", os.path.join(SCRIPTS, "test.sh"), "3", "1", "e"],
                   cwd=tmp_path, env=env, check=True, capture_output=True)
    assert (tmp_path / "cards.txt").read_text().strip() == "3"


def test_library_constructors_need_an_explicit_device():
    """RenderPipeline, testing.synthetic_setup and cli/run.py's
    run_evaluate take ``device`` as a keyword with no default: a caller
    that names none gets a TypeError, not a silent CPU run."""
    kw = dict(image_hw=(16, 16), n_verts=64, n_clusters=8, n_samples=4,
              chunk_rays=8, embed_dim=12, vit_depth=1, vit_heads=2,
              knn_k=3)
    with pytest.raises(TypeError, match="device"):
        synthetic_setup(**kw)
    model, pipe, _, smpl, cluster = synthetic_setup(device="cpu", **kw)
    assert pipe.device == torch.device("cpu")
    with pytest.raises(TypeError, match="device"):
        RenderPipeline(model, cluster, smpl.v_template, n_samples=4)
    with pytest.raises(TypeError, match="device"):
        run_cli.run_evaluate(None, pipe, None)
    # the examples run on the card unless asked: without one that is an
    # error, as in the entry points
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            common.configure_device("cuda")
