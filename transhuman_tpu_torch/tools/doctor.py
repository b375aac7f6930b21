"""Environment and asset check for a new install or a migration
(counterpart of transhuman_tpu/tools/doctor.py).

    python -m transhuman_tpu_torch.tools.doctor [--device cuda|cpu]
        [--cfg_file configs/....yaml] [key value ...]

Checks each thing a run of the port needs and prints one PASS/WARN/FAIL
row for it, with the exact fix: the card (count, name, compute capability
9.0, which the sm_90a kernels need), nvcc and its version, g++, the CUDA
kernel build (kernels/build.py) and the host-library build
(native/build.py), the SMPL file, the k-means dict, the dataset layout
(annots, a sample frame, the vizmaps, the depth maps when ``depth_map`` is
set), the converted weights and the checkpoint (the port's ``.pth`` or a
JAX ``.ckpt`` it resumes).  Without a card the card row is FAIL, or WARN
under ``--device cpu`` (which runs the kernels' plain versions and builds
no kernel).  A failed build is a FAIL with the compiler's output.  Exit
code 1 if any row is FAIL.

Read-only, apart from the build directories the two builds write.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

PASS, WARN, FAIL = "PASS", "WARN", "FAIL"


class Doctor:
    def __init__(self):
        self.rows = []

    def add(self, level, what, detail=""):
        self.rows.append((level, what, detail))

    def report(self) -> int:
        width = max(len(w) for _, w, _ in self.rows) if self.rows else 0
        for level, what, detail in self.rows:
            line = f"[{level}] {what.ljust(width)}"
            if detail:
                line += f"  — {detail}"
            print(line)
        fails = sum(1 for lv, _, _ in self.rows if lv == FAIL)
        warns = sum(1 for lv, _, _ in self.rows if lv == WARN)
        print(f"\n{len(self.rows)} checks: {fails} FAIL, {warns} WARN")
        return 1 if fails else 0


def check_card(d: Doctor, on_card: bool):
    import torch

    absent = FAIL if on_card else WARN
    if not torch.cuda.is_available():
        d.add(absent, "CUDA card",
              "none visible (torch.cuda.is_available() is False)"
              + (": the entry points default to --device cuda and exit"
                 if on_card else ": --device cpu runs the plain versions"))
        return
    n = torch.cuda.device_count()
    names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
    caps = sorted({torch.cuda.get_device_capability(i) for i in range(n)})
    lv = PASS if caps == [(9, 0)] else FAIL
    d.add(lv, "CUDA card", f"{n}x {', '.join(names)}, compute capability "
          + ", ".join(f"{a}.{b}" for a, b in caps)
          + ("" if lv == PASS else ": the kernels are built for sm_90a "
             "(Hopper) and need capability 9.0"))


def check_nvcc(d: Doctor, on_card: bool):
    from ..kernels.build import find_nvcc

    try:
        nvcc = find_nvcc()
    except RuntimeError as e:
        d.add(FAIL if on_card else WARN, "nvcc",
              f"{e}; install the CUDA toolkit or set CUDA_HOME")
        return
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True)
    version = (out.stdout.strip().splitlines() or ["?"])[-1]
    d.add(PASS if out.returncode == 0 else FAIL, "nvcc",
          f"{nvcc}: {version}")


def check_cxx(d: Doctor):
    from ..native.build import CXX

    path = shutil.which(CXX)
    if path is None:
        d.add(FAIL, "g++", f"{CXX} not on PATH: the host libraries (JPEG/PNG "
              "codec, marching, CRC32C, rasterizer) cannot be built")
    else:
        d.add(PASS, "g++", path)


def check_kernel_build(d: Doctor, on_card: bool):
    from ..kernels import build

    if not on_card:
        d.add(WARN, "kernel build", "not built: --device cpu runs the plain "
              "versions (the card builds csrc/*.cu with nvcc on first use)")
        return
    try:
        build.library()
    except (RuntimeError, OSError) as e:
        d.add(FAIL, "kernel build", f"{build.LIB_PATH}: {e}")
        return
    d.add(PASS, "kernel build", build.LIB_PATH)


def check_host_build(d: Doctor):
    from ..native import build

    failed = []
    for name in build.LIBRARIES:
        try:
            build.library(name)
        except (RuntimeError, OSError) as e:
            failed.append(f"lib{name}.so: {e}")
    if failed:
        d.add(FAIL, "host-library build", "\n".join(failed))
    else:
        d.add(PASS, "host-library build",
              f"{', '.join(f'lib{n}.so' for n in build.LIBRARIES)} in "
              f"{build.BUILD_DIR}")


def check_smpl(d: Doctor, cfg):
    from ..geometry.smpl import SMPLModel

    pkl = os.path.join(cfg.smpl_dir, "SMPL_NEUTRAL.pkl")
    if not os.path.exists(pkl):
        d.add(WARN, "SMPL model",
              f"{pkl} missing — the synthetic stand-in body will be used "
              "(tests/benchmarks only; real renders need the real pickle)")
        return
    try:
        m = SMPLModel.load(cfg.smpl_dir)
        d.add(PASS, "SMPL model", f"{pkl} ({m.v_template.shape[0]} verts)")
    except Exception as e:  # noqa: BLE001 — any unreadable pickle is a row
        d.add(FAIL, "SMPL model", f"{pkl} unreadable: {e}")


def check_kmeans(d: Doctor, cfg):
    from ..geometry.clusters import ClusterSpec

    p = os.path.join(cfg.kmeans_dir, f"kmeans_dict_{cfg.num_class}.npy")
    if not os.path.exists(p):
        d.add(WARN, "k-means dict",
              f"{p} missing — k-means over the template runs at every start "
              "(or: python -m transhuman_tpu_torch.tools.make_kmeans "
              f"--smpl_dir {cfg.smpl_dir} --num_clusters {cfg.num_class} "
              f"{cfg.kmeans_dir})")
        return
    try:
        spec = ClusterSpec.load_reference_dict(p)
        d.add(PASS, "k-means dict", f"{p} ({spec.num_clusters} clusters)")
    except Exception as e:  # noqa: BLE001
        d.add(FAIL, "k-means dict", f"{p} unreadable: {e}")


def check_dataset(d: Doctor, cfg):
    if cfg.dataset == "synthetic":
        d.add(PASS, "dataset", "synthetic (generated, no files)")
        return
    root = cfg.data_root
    if not os.path.isdir(root):
        d.add(FAIL, "dataset root",
              f"{root!r} is not a directory (cfg.data_root)")
        return
    import numpy as np

    from ..data import catalog

    split = "test" if cfg.run_mode == "test" else "train"
    try:
        info = catalog.get_human_info(split, cfg.test.mode)
    except KeyError:
        d.add(FAIL, "test mode", f"unknown cfg.test.mode {cfg.test.mode!r}")
        return
    present = [h for h in info if os.path.isdir(os.path.join(root, h))]
    if not present:
        d.add(FAIL, "dataset humans",
              f"none of {list(info)} exist under {root!r}")
        return
    if len(present) < len(info):
        missing = sorted(set(info) - set(present))
        d.add(WARN, "dataset humans", f"missing: {missing} (will be skipped)")
    else:
        d.add(PASS, "dataset humans", f"{len(present)}/{len(info)} present")

    h = present[0]
    ann = os.path.join(root, h, "annots.npy")
    if not os.path.exists(ann):
        d.add(FAIL, "annots", f"{ann} missing")
        return
    try:
        annots = np.load(ann, allow_pickle=True).item()
        d.add(PASS, "annots", f"{ann} ({len(annots['cams']['K'])} cameras, "
              f"{len(annots['ims'])} frames)")
    except Exception as e:  # noqa: BLE001
        d.add(FAIL, "annots", f"{ann} unreadable: {e}")
        return

    # one image, mask, vertices and params, through the loader itself
    try:
        from ..cli.common import load_smpl
        from ..data.zju import ZJUDataset

        ds = ZJUDataset(cfg, split, smpl=load_smpl(cfg),
                        human_info={k: info[k] for k in present})
        item = ds.get_eval_item(0)
        d.add(PASS, "sample frame",
              f"{item.human} f{item.frame_index}: image "
              f"{item.target_img.shape}, {item.eval_rays.rays.ray_o.shape[0]}"
              " rays in box")
    except Exception as e:  # noqa: BLE001
        d.add(FAIL, "sample frame", f"loading item 0 failed: {e}")

    rast = os.path.join(cfg.rasterize_root, h, "visibility")
    if cfg.rasterize and not os.path.isdir(rast):
        d.add(WARN, "vizmaps",
              f"{rast} missing — all-ones visibility (the reference's "
              "fallback; worse painting)")
    elif cfg.rasterize:
        d.add(PASS, "vizmaps", rast)
    if cfg.depth_map:
        depth = os.path.join(cfg.depth_root, h)
        if os.path.isdir(depth):
            d.add(PASS, "depth maps", depth)
        else:
            d.add(FAIL if cfg.depth_vizmap else WARN, "depth maps",
                  f"{depth} missing (cfg.depth_root/<human>/<camera>/"
                  "<frame>.pt" + (", which depth_vizmap reads)"
                                  if cfg.depth_vizmap else ")"))


def check_weights(d: Doctor, cfg):
    if cfg.encoder_weights:
        lv = PASS if os.path.exists(cfg.encoder_weights) else FAIL
        d.add(lv, "encoder weights (ResNet18)", cfg.encoder_weights)
    elif cfg.pretrained:
        d.add(WARN, "encoder weights (ResNet18)",
              "cfg.pretrained=True but encoder_weights unset — random "
              "encoder init (convert with python -m "
              "transhuman_tpu_torch.tools.convert_resnet)")
    if cfg.lpips_weights:
        lv = PASS if os.path.exists(cfg.lpips_weights) else FAIL
        d.add(lv, "LPIPS weights", cfg.lpips_weights)
    else:
        d.add(WARN, "LPIPS weights",
              "unset — perceptual loss and eval LPIPS column disabled "
              "(convert with python -m transhuman_tpu_torch.tools."
              "convert_lpips)")


def check_checkpoint(d: Doctor, cfg):
    from ..cli.common import model_dir
    from ..train.checkpoint import find_checkpoint

    mdir = model_dir(cfg)
    path = find_checkpoint(mdir, cfg.test.epoch)
    if path is not None:
        kind = ("a JAX package .ckpt, which the port reads"
                if path.endswith(".ckpt") else "the port's .pth")
        d.add(PASS, "checkpoint", f"{path} ({kind})")
    elif cfg.run_mode == "test":
        d.add(FAIL, "checkpoint",
              f"none for test.epoch {cfg.test.epoch} under {mdir} — "
              "evaluate/visualize need one (train with python -m "
              "transhuman_tpu_torch.cli.train, or pass the official .pth "
              "with --weights)")
    else:
        d.add(WARN, "checkpoint", f"none under {mdir} (a fresh training run)")


def main(argv=None) -> int:
    from ..cli.common import add_config_args
    from ..config import Config

    p = argparse.ArgumentParser(prog="python -m transhuman_tpu_torch.tools."
                                "doctor")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the runs will use (cpu: no card, nvcc "
                        "or kernel build is needed)")
    add_config_args(p)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    cfg = Config.from_yaml(args.cfg_file, args.opts)
    on_card = args.device == "cuda"

    d = Doctor()
    check_card(d, on_card)
    check_nvcc(d, on_card)
    check_cxx(d)
    check_kernel_build(d, on_card)
    check_host_build(d)
    check_smpl(d, cfg)
    check_kmeans(d, cfg)
    check_dataset(d, cfg)
    check_weights(d, cfg)
    check_checkpoint(d, cfg)
    return d.report()


if __name__ == "__main__":
    sys.exit(main())
