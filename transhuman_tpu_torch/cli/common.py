"""Shared entry-point plumbing: arguments and config, body model, cluster
table, model + pipeline, dataset, output and checkpoint paths (counterpart
of transhuman_tpu/cli/common.py)."""

from __future__ import annotations

import argparse
import os
import random
import sys
from typing import Optional

import numpy as np
import torch

from ..config import Config, check_supported
from ..geometry.clusters import ClusterSpec
from ..geometry.smpl import SMPLModel
from ..registry import (DATASETS, NETWORKS, RENDERERS, check_plugins,
                        load_builtins)


def add_config_args(p: argparse.ArgumentParser):
    """--cfg_file and the trailing ``key value`` overrides."""
    p.add_argument("--cfg_file", default=None,
                   help="a reference-format YAML config (configs/*.yaml)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="config overrides: key value ...")


def load_config(args) -> Config:
    """The config of ``--cfg_file`` with the overrides applied, as the JAX
    package's ``Config.from_yaml``; a value the port cannot run is an
    error by name, and a plugin name no implementation registered the
    registry's KeyError."""
    return check_plugins(check_supported(Config.from_yaml(args.cfg_file,
                                                          args.opts)))


def parse_args(argv=None, need_type: bool = False, allow_test: bool = False,
               prog: Optional[str] = None, extra=None):
    """(args, cfg) of an entry point: --cfg_file, --device, --weights, the
    overrides; --test (allow_test), --type/--ply/--occupancy_out
    (need_type); extra(parser) adds an entry point's own flags."""
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    p.add_argument("--dist_backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="under torchrun: the process group's backend (gloo "
                        "lets several ranks share a card; --device cpu "
                        "always uses gloo)")
    p.add_argument("--weights", default=None,
                   help="a checkpoint: the port's .pth or the JAX package's "
                        ".ckpt (default: the latest in <trained_model_dir>/"
                        "<task>/<exp_name>, or test.epoch's)")
    if allow_test:
        p.add_argument("--test", action="store_true",
                       help="validation pass instead of training: weights-"
                            "only load, val loss stats + the evaluator over "
                            "the test split")
    if need_type:
        p.add_argument("--type", default="evaluate",
                       choices=["evaluate", "visualize", "reconstruction",
                                "light_stage"])
        p.add_argument("--ply", default=None, help="light_stage: input .ply")
        p.add_argument("--occupancy_out", default=None,
                       help="light_stage: output .npy (default <ply>"
                            ".occupancy.npy)")
    if extra is not None:
        extra(p)
    add_config_args(p)
    args = p.parse_args(argv)
    return args, load_config(args)


def seed_everything(seed: int):
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def configure_device(name: str, dist_backend: str = "nccl",
                     rays: int = 1) -> torch.device:
    """The device an entry point runs on.  For a card: fail without one,
    and take float32 products and convolutions in full float32 (TF32 off;
    cuDNN convolutions default to TF32) and bf16 products with float32
    accumulation (cuBLAS may otherwise reduce them in bf16, which XLA does
    not).  Under torchrun (LOCAL_RANK set) a rank takes card LOCAL_RANK
    and makes it current; more local ranks than cards is an error with the
    counts, unless dist_backend is gloo, where the ranks share the cards
    round-robin and say so (NCCL refuses two ranks on one card).  With
    ``rays`` = mesh_axis_rays R > 1 each rank owns R cards and takes card
    LOCAL_RANK·R, the first of them; LOCAL_WORLD_SIZE·R cards more than
    there are is an error with the counts, on any backend."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but no CUDA device is available")
        if "LOCAL_RANK" in os.environ and device.index is None:
            local = int(os.environ["LOCAL_RANK"])
            n_local = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
            cards = torch.cuda.device_count()
            if rays > 1:
                if n_local * rays > cards:
                    raise SystemExit(
                        f"{n_local} local ranks x mesh_axis_rays {rays} need "
                        f"{n_local * rays} CUDA cards but {cards} are "
                        f"visible; launch at most {cards // rays} ranks per "
                        "node")
                local *= rays
            elif n_local > cards:
                if dist_backend != "gloo":
                    raise SystemExit(
                        f"{n_local} local ranks but {cards} CUDA card(s): "
                        f"{dist_backend} runs one rank per card; launch at "
                        f"most {cards} ranks per node, or pass "
                        "--dist_backend gloo to share the cards")
                print(f"local rank {local} of {n_local}: {cards} card(s) "
                      f"shared round-robin over gloo; this rank on cuda:"
                      f"{local % cards}", flush=True)
            device = torch.device("cuda", local % cards)
            torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    return device


def maybe_init_distributed(args, device) -> bool:
    """Join the process group torchrun describes (nothing outside
    torchrun): over args.dist_backend on a card, over gloo on the CPU.
    True when this call made the group (the caller then leaves it with
    parallel.shutdown)."""
    from ..parallel.mesh import init_distributed

    backend = "gloo" if device.type == "cpu" else args.dist_backend
    return init_distributed(backend)


def card_identity() -> Optional[dict]:
    """The card this process has made current: its index, its UUID and
    its PCI address (None where this torch does not report them); None in
    a process that has not touched a card."""
    if not torch.cuda.is_initialized():
        return None
    index = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    pci = None
    if hasattr(props, "pci_bus_id"):
        pci = (f"{getattr(props, 'pci_domain_id', 0):04x}:"
               f"{props.pci_bus_id:02x}:"
               f"{getattr(props, 'pci_device_id', 0):02x}")
    return {"index": index, "name": props.name,
            "uuid": None if uuid is None else str(uuid), "pci": pci}


def rank_report(mesh, **fields) -> None:
    """One JSON line of a rank's own numbers (its rank, the world size,
    the card it runs on, the kernel launches it made, and ``fields``),
    after a distributed run."""
    import json

    from .. import kernels

    line = "rank report: " + json.dumps({
        "rank": mesh.rank, "world": mesh.size, "card": card_identity(),
        **fields, "launches": kernels.launch_counts()})
    # one write, so that ranks sharing a terminal do not interleave it
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


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


def build_runtime(cfg: Config, device, smpl: Optional[SMPLModel] = None,
                  pe_table=None):
    """(model, pipe, smpl, cluster) with the model's weights on ``device``
    (freshly initialised: load a checkpoint into ``model`` afterwards);
    pe_table is a checkpoint's stored TransHE table, or None.  The pipe
    culls with ``cull_radii``'s per-vertex radii when it names an npz
    (key ``radii``, as ``tools/measure_vertex_radii`` writes it), and takes
    ``remat`` and ``train.cull``.  cfg.network and cfg.renderer pick the
    implementations by registry name (the reference's make_network and
    make_renderer)."""
    load_builtins()
    if smpl is None:
        smpl = load_smpl(cfg)
    cluster = load_cluster_spec(cfg, smpl)
    model = NETWORKS.get(cfg.network)(cfg).to(device).eval()
    vertex_radii = None
    if cfg.cull_radii:
        with np.load(cfg.cull_radii) as z:
            vertex_radii = np.asarray(z["radii"], np.float32)
    pipe = RENDERERS.get(cfg.renderer)(model, cluster, smpl.v_template, cfg,
                                       device, pe_table=pe_table,
                                       vertex_radii=vertex_radii)
    return model, pipe, smpl, cluster


def make_dataset(cfg: Config, split: str, smpl: Optional[SMPLModel] = None):
    """The dataset cfg.dataset names in the registry (the reference's
    make_dataset): ``zju``, the ZJU-MoCap layout under cfg.data_root
    (data/zju.py), posed by ``smpl`` (default: load_smpl's);
    ``synthetic``, the seeded synthetic scene at the render size
    (H_render x W_render)."""
    load_builtins()
    return DATASETS.get(cfg.dataset)(cfg, split, smpl=smpl)


def model_dir(cfg: Config) -> str:
    return os.path.join(cfg.trained_model_dir, cfg.task, cfg.exp_name)


def result_dir(cfg: Config) -> str:
    return os.path.join(cfg.result_dir, f"epoch_{cfg.test.epoch}",
                        cfg.test.exp_folder_name)


def checkpoint_path(cfg: Config, weights: Optional[str] = None) -> str:
    """``weights`` when given (a port .pth or a JAX .ckpt), else
    test.epoch's checkpoint in model_dir (train/checkpoint.py::
    find_checkpoint: the port's latest.pth / <epoch>.pth, failing those the
    JAX package's latest.ckpt / ep<epoch>.ckpt).  A missing file is an
    error: nothing renders from silent random weights."""
    from ..train.checkpoint import find_checkpoint

    if not weights:
        weights = find_checkpoint(model_dir(cfg), cfg.test.epoch) or \
            os.path.join(model_dir(cfg), "latest.pth" if cfg.test.epoch < 0
                         else f"{cfg.test.epoch}.pth")
    if not os.path.isfile(weights):
        raise FileNotFoundError(
            f"no checkpoint at {weights!r}: train one (python -m "
            "transhuman_tpu_torch.cli.train) or pass --weights PATH")
    return weights

