"""Shared entry-point plumbing: body model, cluster table, model + pipeline,
dataset, output and checkpoint paths (counterpart of
transhuman_tpu/cli/common.py)."""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from ..config import Config
from ..geometry.clusters import ClusterSpec
from ..geometry.smpl import SMPLModel
from ..models.network import TransHumanNet
from ..render.pipeline import RenderPipeline


def configure_device(name: str) -> torch.device:
    """The device an entry point runs on.  For a card: fail without one,
    and take float32 products and convolutions in full float32 (TF32 off;
    cuDNN convolutions default to TF32) and bf16 products with float32
    accumulation (cuBLAS may otherwise reduce them in bf16, which XLA does
    not)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    return device


def load_smpl(cfg: Config) -> SMPLModel:
    """The licensed SMPL model from cfg.smpl_dir, or the seeded stand-in."""
    try:
        return SMPLModel.load(cfg.smpl_dir)
    except (FileNotFoundError, OSError):
        print(f"WARNING: SMPL pickle not found under {cfg.smpl_dir!r}; using "
              "the synthetic stand-in body (tests/benchmarks only).",
              file=sys.stderr)
        return SMPLModel.synthetic()


def load_cluster_spec(cfg: Config, smpl: SMPLModel) -> ClusterSpec:
    """The reference kmeans table for cfg.num_class, or k-means over the
    template when the table is absent."""
    path = os.path.join(cfg.kmeans_dir, f"kmeans_dict_{cfg.num_class}.npy")
    if os.path.exists(path):
        return ClusterSpec.load_reference_dict(path)
    print(f"WARNING: {path} not found; running k-means over the template.",
          file=sys.stderr)
    return ClusterSpec.from_kmeans(smpl.v_template, cfg.num_class)


def build_runtime(cfg: Config, device, smpl: Optional[SMPLModel] = None):
    """(model, pipe, smpl, cluster) with the model's weights on ``device``
    (freshly initialised: load a checkpoint into ``model`` afterwards)."""
    if smpl is None:
        smpl = load_smpl(cfg)
    cluster = load_cluster_spec(cfg, smpl)
    model = TransHumanNet.from_config(cfg).to(device).eval()
    pipe = RenderPipeline(
        model, cluster, smpl.v_template, n_samples=cfg.N_samples,
        chunk_rays=max(cfg.chunk_size // cfg.N_samples, 1),
        cull_distance=cfg.cull_distance, white_bkgd=cfg.white_bkgd,
        raw_noise_std=cfg.raw_noise_std, device=device,
    )
    return model, pipe, smpl, cluster


def make_dataset(cfg: Config, split: str):
    """The seeded synthetic scene at the render size (H_render x W_render):
    the only data the repository holds (the ZJU-MoCap loader is not
    ported)."""
    from ..data.synthetic import SyntheticDataset

    return SyntheticDataset(cfg, split, image_hw=(cfg.H_render, cfg.W_render))


def model_dir(cfg: Config) -> str:
    return os.path.join(cfg.trained_model_dir, cfg.task, cfg.exp_name)


def result_dir(cfg: Config) -> str:
    return os.path.join(cfg.result_dir, f"epoch_{cfg.test.epoch}",
                        cfg.test.exp_folder_name)


def checkpoint_path(cfg: Config, weights: Optional[str] = None) -> str:
    """``weights`` when given, else ``model_dir/latest.pth`` for
    test.epoch -1 and ``model_dir/<epoch>.pth`` otherwise.  A missing file
    is an error: nothing renders from silent random weights."""
    if not weights:
        name = ("latest.pth" if cfg.test.epoch < 0
                else f"{cfg.test.epoch}.pth")
        weights = os.path.join(model_dir(cfg), name)
    if not os.path.isfile(weights):
        raise FileNotFoundError(
            f"no checkpoint at {weights!r}: train one (python -m "
            "transhuman_tpu_torch.cli.train) or pass --weights PATH")
    return weights

