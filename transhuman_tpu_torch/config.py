"""The configuration of the port: every key of transhuman_tpu/config.py::Config,
with the same names, defaults and merge rules, and a reader for the repo's
YAML config files that needs no PyYAML (``utils/yaml_subset.py``).

``Config.from_yaml(path, opts)`` reads a reference-format file and applies
``key value key value ...`` overrides (dotted keys reach nested sections) as
the JAX package does: strings parsed by ``_parse_scalar``, types checked by
``_check_type`` (int widens to float, list and tuple interchange), the
reference's module-path keys ignored (``_IGNORED_KEYS``), ``dataset`` h36m
and thu read as zju, and any other unknown key an error.

Each key is in one of the classes of ``KEY_CLASSES``:

* ``honoured``: the port reads it;
* ``tpu_only``: it steers the JAX package's TPU execution only; setting it
  warns and changes nothing here;
* ``unused``: it feeds only the ZJU-MoCap loader and its samplers, or
  neither package; accepted and unused while ``dataset`` is ``synthetic``.

``check_supported`` refuses, by name, a value the port cannot run
(``REFUSED``: another network or renderer, ``compute_dtype float16`` ...);
an unknown ``dataset`` is refused where a dataset is built
(``cli/common.py::make_dataset``).
"""

from __future__ import annotations

import ast
import dataclasses
import sys
from dataclasses import dataclass, field
from typing import Any, List, Optional


def _parse_scalar(v: str) -> Any:
    """Parse an override string the way yacs' literal_eval merge did (the
    JAX package's ``_parse_scalar``)."""
    if not isinstance(v, str):
        return v
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if v.startswith(("[", "(", "{")) or "," in v:
        # `test.input_view 0,7,15` -> [0, 7, 15]; `test.target_view 3,` -> [3]
        try:
            out = ast.literal_eval(v)
            return list(out) if isinstance(out, tuple) else out
        except (ValueError, SyntaxError):
            pass
    return v


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
    batch_size: int = 1  # samples per step, BatchNorm pooled over them
    lr: float = 7e-4
    epoch: int = 3000
    num_workers: int = 1  # train sample prefetch: num_workers + 1 threads
    optim: str = "adam"  # adam | adamw | radam | sgd
    weight_decay: float = 0.0
    shuffle: bool = True
    accum_steps: int = 1  # microbatches per step (train/step.py)
    cull: bool = False  # the SMPL cull on the train decode
    cull_ratio: float = 0.35
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)


@dataclass
class TestConfig:
    """Evaluation (reference configs/train_or_eval.yaml ``test``)."""

    sampler: str = "FrameSampler"
    batch_size: int = 1
    collator: str = ""
    epoch: int = -1  # -1: latest; N: epoch N's copy
    full_eval: bool = False
    exp_folder_name: str = "debug"
    time_det: int = 20
    input_view: List[int] = field(default_factory=lambda: [0, 7, 15])
    target_view: List[int] = field(
        default_factory=lambda: [3, 5, 10, 12, 18, 20])
    mode: str = "model_x_motion_x"
    frame_interval: int = 30  # FrameSampler decimation


@dataclass
class Config:
    exp_name: str = "transhuman_tpu"
    task: str = "transhuman"

    # plugin selection
    dataset: str = "zju"  # [zju | synthetic]; the port builds synthetic
    network: str = "transhuman"
    renderer: str = "clight"
    trainer: str = "clight"
    evaluator: str = "if_nerf"
    visualizer: str = "perform"

    # dataset options
    ratio: float = 0.5
    H: int = 1024
    W: int = 1024
    white_bkgd: bool = False
    mask_bkgd: bool = True
    N_rand: int = 1024
    perturb: float = 1.0
    train_num_views: int = 3
    time_steps: int = 1
    time_mult: List[int] = field(default_factory=lambda: [0, -20, 20])
    data_root: str = "data/zju_mocap"
    rasterize_root: str = "data/zju_rasterization"
    smpl_dir: str = "data/smplx/smpl"
    kmeans_dir: str = "data/kmeans_dict"
    big_box: bool = False
    rot_ratio: float = 0.0
    vertices: str = "new_vertices"
    params: str = "new_params"
    use_viz_test: bool = True
    rasterize: bool = True
    jitter: bool = True
    depth_map: bool = False
    depth_vizmap: bool = False
    depth_root: str = "data/zju_depth_map_train"

    # misc
    gpus: List[int] = field(default_factory=lambda: [0])
    seed: int = 123
    use_record: bool = True
    log_interval: int = 1
    record_interval: int = 20
    N_samples: int = 64
    save_freq: int = 5
    save_latest_ep: int = 5
    ep_iter: int = 500
    resume: bool = True
    specified_resume: str = ""
    run_mode: str = "train"  # train | test

    # architecture
    pretrained: bool = True
    encoder_weights: str = ""  # converted ResNet-18 npz; '' = random init
    lpips_weights: str = ""  # converted LPIPS npz; '' disables LPIPS
    lpips_backbone: str = ""  # VGG16 npz when lpips_weights is lins-only
    xyz_res: int = 10
    view_res: int = 4
    raw_noise_std: float = 0.0
    vit_depth: int = 12
    vit_variant: str = "tiny"
    num_class: int = 300
    KNN: int = 7
    KNN_FREQ: int = 10
    KNN_DIST_ALPHA: float = 0.5
    KNN_SIGMA: float = 0.25
    use_truncation: bool = False

    # execution
    compute_dtype: str = "float32"  # float32 | bfloat16
    chunk_size: int = 32768  # points per decode chunk
    cull_distance: float = 0.1
    cull_radii: str = ""  # npz of per-vertex cull radii (key 'radii')
    pad_bucket: int = 8192
    use_pallas_knn: bool = False
    compact_ratio: Optional[float] = 0.3
    mesh_axis_data: int = 0
    mesh_axis_rays: int = 1
    mesh_axis_model: int = 1
    remat: bool = False  # recompute the train decode in the backward

    # ray sampling
    patch: PatchConfig = field(default_factory=PatchConfig)
    face_sample_ratio: float = 0.0
    body_sample_ratio: float = 0.5
    sample_fg_ratio: float = 0.7

    # loss
    l2rec_weight: float = 1.0
    lpips_weight: float = 0.1

    # mesh reconstruction: iso-level of sigma, grid voxel (m) per axis
    mesh_th: float = 20.0
    voxel_size: List[float] = field(
        default_factory=lambda: [0.005, 0.005, 0.005])

    # free-viewpoint rendering
    render_views: int = 100

    # output dirs
    trained_model_dir: str = "data/trained_model"
    record_dir: str = "data/record"
    result_dir: str = "data/result"

    # non-empty: the train entry point traces steps 5-8 (fewer in a short
    # run) with torch.profiler and writes the trace and its summary here
    profile_dir: str = ""

    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)

    @property
    def H_render(self) -> int:
        return int(self.H * self.ratio)

    @property
    def W_render(self) -> int:
        return int(self.W * self.ratio)

    def merge_dict(self, d: dict) -> "Config":
        """A copy with the (nested) dict merged in; self is unchanged."""
        return _merge_into(self, d, "")

    def merge_opts(self, opts: List[str]) -> "Config":
        """A copy with ``key value`` overrides applied (dotted keys reach
        nested sections, e.g. ``test.input_view 0,7,15``)."""
        if not opts:
            return self
        if len(opts) % 2:
            raise ValueError(f"overrides must be key value pairs: {opts}")
        d: dict = {}
        for k, v in zip(opts[0::2], opts[1::2]):
            node = d
            parts = k.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return self.merge_dict(d)

    @classmethod
    def from_yaml(cls, path: Optional[str] = None,
                  opts: Optional[List[str]] = None) -> "Config":
        cfg = cls()
        if path:
            from .utils.yaml_subset import load_file

            cfg = cfg.merge_dict(load_file(path) or {})
        if opts:
            cfg = cfg.merge_opts(list(opts))
        return cfg


# the reference's module-path and bookkeeping keys: ignored on load, as the
# JAX package ignores them
_IGNORED_KEYS = {
    "dataset_module", "dataset_path", "cross_transformer_network_module",
    "cross_transformer_network_path", "renderer_module", "renderer_path",
    "trainer_module", "trainer_path", "evaluator_module", "evaluator_path",
    "visualizer_module", "visualizer_path", "global_iter", "flag_train",
    "img_feat_size", "embed_size", "local_rank", "distributed",
}
# configs/performance.yaml and reconstruction.yaml name their reference
# dataset module's variant in ``dataset_variant``, which no Config holds:
# the JAX package's from_yaml raises KeyError on both files.  The port
# ignores the key, so that those files load (the same merge otherwise).
PORT_IGNORED_KEYS = frozenset({"dataset_variant"})


class UnknownKeyError(KeyError, ValueError):
    """An unknown config key (a KeyError, as in the JAX package)."""

    def __str__(self):
        return self.args[0]


class ConfigTypeError(TypeError, ValueError):
    """A value of the wrong type for its key (a TypeError, as in the JAX
    package)."""


def _merge_into(obj, d: dict, prefix: str):
    fields = {f.name: f for f in dataclasses.fields(obj)}
    updates = {}
    for k, v in d.items():
        if k in _IGNORED_KEYS or (not prefix and k in PORT_IGNORED_KEYS):
            continue
        if k == "dataset" and isinstance(v, str) and v in ("h36m", "thu"):
            # the reference documents dataset [zju | h36m | thu]; all three
            # load the zju layout
            v = "zju"
        key = prefix + k
        if k not in fields:
            raise UnknownKeyError(
                f"Unknown config key: {key!r} (an unknown key is an error, "
                "as in the JAX package)")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur):
            if not isinstance(v, dict):
                raise ConfigTypeError(
                    f"config key {key!r} is a section; got scalar {v!r}")
            updates[k] = _merge_into(cur, v, key + ".")
            continue
        if isinstance(v, str):
            # str-typed fields take values verbatim: `exp_name 1,2` is "1,2"
            v = v if isinstance(cur, str) else _parse_scalar(v)
        updates[k] = _check_type(key, cur, v)
        if key in TPU_ONLY_KEYS:
            print(f"WARNING: config key {key!r} steers the TPU package "
                  "only; ignored", file=sys.stderr)
    return dataclasses.replace(obj, **updates)


def _check_type(key, cur, new):
    """The JAX package's merge type check: int widens to float, None
    accepts anything, list and tuple interchange.  The port also holds a
    list's items to the default's item type (float items take ints; int
    items refuse 0.5)."""
    if cur is None or new is None:
        return new
    if type(new) is type(cur) and not isinstance(cur, list):
        return new
    if isinstance(cur, float) and type(new) is int:
        return float(new)
    if isinstance(cur, (list, tuple)) and isinstance(new, (list, tuple)):
        item = type(cur[0]) if cur else None
        out = []
        for x in new:
            if item is float and type(x) is int:
                x = float(x)
            elif item is not None and type(x) is not item:
                raise ConfigTypeError(
                    f"bad value {new!r} for config key {key!r}: items must "
                    f"be {item.__name__}")
            out.append(x)
        return type(cur)(out)
    hint = ""
    if isinstance(cur, (list, tuple)):
        hint = " (list field: a single value needs a trailing comma, e.g. '3,')"
    raise ConfigTypeError(
        f"bad value {new!r} for config key {key!r}: expected "
        f"{type(cur).__name__}, got {type(new).__name__}{hint}")


# ------------------------------------------------------------ key classes
# TPU/static-shape execution knobs of the JAX package with no job here
TPU_ONLY_KEYS = frozenset({
    "pad_bucket", "compact_ratio", "use_pallas_knn", "mesh_axis_data",
    "mesh_axis_rays", "mesh_axis_model",
})
# read by neither package (xyz_res, save_latest_ep, gpus, test.collator,
# test.time_det, test.batch_size, train.scheduler.type: the JAX package reads
# none of them either), or by JAX code the port does not carry (time_mult:
# time_steps is 1; use_viz_test; sample_fg_ratio; train.shuffle).
# train.cull_ratio sizes the JAX package's static capacity for the train
# cull's survivors; the port compacts them dynamically (one nonzero per
# sample), has no capacity to size, and so cannot overflow.
UNUSED_KEYS = frozenset({
    "time_mult", "use_viz_test", "sample_fg_ratio",
    "test.collator", "test.time_det", "test.batch_size", "train.shuffle",
    "train.cull_ratio", "train.scheduler.type", "gpus", "xyz_res",
    "save_latest_ep",
})
# key -> (the values the port runs, why another value is refused)
REFUSED = {
    "network": ({"transhuman"}, "the port has the 'transhuman' network "
                "only"),
    "renderer": ({"clight"}, "the port has the 'clight' renderer only"),
    "trainer": ({"clight"}, "the port has the 'clight' trainer only"),
    "evaluator": ({"if_nerf"}, "the port has the 'if_nerf' evaluator only"),
    "visualizer": ({"perform"}, "the port has the 'perform' visualizer "
                   "only"),
    "compute_dtype": ({"float32", "bfloat16"}, "the port computes in "
                      "float32 or bfloat16"),
    "vit_variant": ({"tiny", "small", "base"}, "TransHE comes in tiny, small "
                    "and base"),
    "run_mode": ({"train", "test"}, "run_mode is train or test"),
}
# the datasets the port builds (the serve entry point builds none)
DATASETS = ("synthetic", "zju")


def flat_keys(cfg=None, prefix: str = "") -> dict:
    """{dotted key: value} of every leaf of cfg (default: the defaults)."""
    cfg = Config() if cfg is None else cfg
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flat_keys(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def _key_class(key: str) -> str:
    if key in TPU_ONLY_KEYS:
        return "tpu_only"
    if key in UNUSED_KEYS:
        return "unused"
    return "honoured"


KEY_CLASSES = {k: _key_class(k) for k in flat_keys()}


def check_supported(cfg: Config) -> Config:
    """cfg, or ValueError naming the first key set to a value the port
    cannot run and why."""
    values = flat_keys(cfg)
    for key, (ok, why) in REFUSED.items():
        if values[key] not in ok:
            raise ValueError(f"config {key} {values[key]!r}: not runnable in "
                             f"the PyTorch port: {why}")
    return cfg
