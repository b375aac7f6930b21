"""The serving, training and evaluation configuration of the port.

The keys that the render, train and eval paths read, with the names and defaults of
transhuman_tpu/config.py::Config (which mirror the reference's
``configs/train_or_eval.yaml``); tests hold the defaults equal.  ``merge_opts``
takes the reference's ``key value key value ...`` override list.  Keys that
only steer the JAX package's TPU execution are ignored with a warning; any
other unknown key is an error.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass, field
from typing import List

# TPU/static-shape execution knobs of the JAX package with no job here
TPU_ONLY_KEYS = frozenset({
    "pad_bucket", "compact_ratio", "use_pallas_knn", "mesh_axis_data",
    "mesh_axis_rays", "mesh_axis_model", "remat",
})


@dataclass
class TestConfig:
    """Evaluation (reference configs/train_or_eval.yaml ``test``)."""

    sampler: str = "FrameSampler"
    epoch: int = -1  # -1: latest.pth; N: N.pth
    full_eval: bool = False
    exp_folder_name: str = "debug"
    input_view: List[int] = field(default_factory=lambda: [0, 7, 15])
    frame_interval: int = 30  # FrameSampler decimation


@dataclass
class PatchConfig:
    """Patch-based ray sampling (reference configs/train_or_eval.yaml)."""

    use_patch_sampling: bool = True
    sample_subject_ratio: float = 0.8
    N_patches: int = 6
    size: int = 20


@dataclass
class SchedulerConfig:
    """Warmup + cosine learning rate, stepped per epoch."""

    type: str = "cosine"
    warmup_epochs: int = 300
    decay_epochs: int = 3000
    end_lr: float = 1e-6


@dataclass
class TrainConfig:
    batch_size: int = 1  # the port trains 1 sample per step (train/step.py)
    lr: float = 7e-4
    epoch: int = 3000
    optim: str = "adam"  # adam | adamw | radam | sgd
    weight_decay: float = 0.0
    accum_steps: int = 1  # the port takes 1 only
    cull: bool = False  # the SMPL cull on the train decode: not ported yet
    cull_ratio: float = 0.35
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)


@dataclass
class Config:
    # dataset / request defaults
    ratio: float = 0.5
    H: int = 1024
    W: int = 1024
    white_bkgd: bool = False
    mask_bkgd: bool = True
    big_box: bool = False
    N_rand: int = 1024
    perturb: float = 1.0
    train_num_views: int = 3
    smpl_dir: str = "data/smplx/smpl"
    kmeans_dir: str = "data/kmeans_dict"
    # architecture
    N_samples: int = 64
    view_res: int = 4
    vit_depth: int = 12
    vit_variant: str = "tiny"
    num_class: int = 300
    KNN: int = 7
    KNN_FREQ: int = 10
    KNN_DIST_ALPHA: float = 0.5
    KNN_SIGMA: float = 0.25
    use_truncation: bool = False
    raw_noise_std: float = 0.0
    # training
    seed: int = 123
    ep_iter: int = 500
    exp_name: str = "transhuman_tpu"
    task: str = "transhuman"
    trained_model_dir: str = "data/trained_model"
    l2rec_weight: float = 1.0
    lpips_weight: float = 0.1
    lpips_weights: str = ""  # '' disables LPIPS (not ported yet)
    train: TrainConfig = field(default_factory=TrainConfig)
    patch: PatchConfig = field(default_factory=PatchConfig)
    # execution
    compute_dtype: str = "float32"
    chunk_size: int = 32768  # points per decode chunk
    cull_distance: float = 0.1
    # non-empty: the train entry point traces steps 5-8 (fewer in a short
    # run) with torch.profiler and writes the trace and its summary here
    profile_dir: str = ""
    test: TestConfig = field(default_factory=TestConfig)
    # evaluation and free-viewpoint rendering
    evaluator: str = "if_nerf"
    visualizer: str = "perform"
    render_views: int = 100
    result_dir: str = "data/result"

    @property
    def H_render(self) -> int:
        return int(self.H * self.ratio)

    @property
    def W_render(self) -> int:
        return int(self.W * self.ratio)

    def merge_opts(self, opts: List[str]) -> "Config":
        """A copy with ``key value`` overrides applied (dotted keys reach
        nested sections, e.g. ``test.input_view 0,7,15``)."""
        if len(opts) % 2:
            raise ValueError(f"overrides must be key value pairs: {opts}")
        out = dataclasses.replace(
            self, test=dataclasses.replace(self.test),
            patch=dataclasses.replace(self.patch),
            train=dataclasses.replace(
                self.train,
                scheduler=dataclasses.replace(self.train.scheduler)))
        for key, raw in zip(opts[0::2], opts[1::2]):
            if key in TPU_ONLY_KEYS:
                print(f"WARNING: config key {key!r} steers the TPU package "
                      "only; ignored", file=sys.stderr)
                continue
            *path, name = key.split(".")
            node = out
            for p in path:
                node = getattr(node, p, None)
            if node is None or name not in {
                    f.name for f in dataclasses.fields(node)}:
                raise ValueError(f"unknown or unsupported config key {key!r}")
            setattr(node, name, _coerce(getattr(node, name), raw, key))
        return out


def _coerce(cur, raw, key):
    if not isinstance(raw, str):
        return raw
    try:
        if isinstance(cur, bool):
            if raw.lower() not in ("true", "false"):
                raise ValueError(raw)
            return raw.lower() == "true"
        if isinstance(cur, list):
            return [int(x) for x in raw.strip("[]() ").split(",") if x.strip()]
        return type(cur)(raw)
    except ValueError as e:
        raise ValueError(f"bad value {raw!r} for config key {key!r}") from e
