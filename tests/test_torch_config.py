"""The port's config: its YAML reader against PyYAML (in a process where
PyYAML cannot be imported), its merge against the JAX package's
Config.from_yaml key by key, and every JAX key classed as honoured,
TPU-only or unused, with the values the port cannot run refused by name."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from transhuman_tpu.config import Config as JConfig
from transhuman_tpu_torch import config as tconfig
from transhuman_tpu_torch.cli import common
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.utils.yaml_subset import YAMLSubsetError, load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["train_or_eval", "performance", "reconstruction"]

_PROBE = r"""
import json, sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("yaml", "jax", "transhuman_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, _Blocked())
from transhuman_tpu_torch.utils.yaml_subset import load_file
print(json.dumps({f: load_file("configs/%s.yaml" % f) for f in sys.argv[1:]}))
"""


@pytest.fixture(scope="module")
def parsed_without_pyyaml():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, *FILES], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _yaml(name):
    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("name", FILES)
def test_config_files_parse_as_pyyaml_parses_them(parsed_without_pyyaml,
                                                  name):
    want = _yaml(name)
    assert parsed_without_pyyaml[name] == json.loads(json.dumps(want))
    if name == "train_or_eval":
        # YAML 1.1 floats need a dot: both readers keep these as strings
        assert want["train"]["lr"] == "7e-4"
        assert want["train"]["scheduler"]["end_lr"] == "1e-6"
        assert parsed_without_pyyaml[name]["train"]["lr"] == "7e-4"


SCALARS = [
    "a: 7e-4", "a: 1.5e-3", "a: .5", "a: 1.", "a: -1", "a: +1", "a: 0",
    "a: yes", "a: Off", "a: ON", "a: TRUE", "a: 010", "a: 0x1F", "a: 0b101",
    "a: 1:30", "a: 1_000", "a: ~", "a: null", "a:", "a: ''", "a: \"\"",
    "a: 'it''s'", 'a: "x\\ty"', "a: [0, -20, 20]", "a: []",
    "a: [x, 'b c', 1.0, [1, 2]]", "a: [1, 2,]", "a: x # note", "a: a#b",
    "a: .inf", "a: -.inf", "a: 12e3", "a: 0o7", "a: data/zju_mocap",
    "a: 1:2.5", "a: -0", "a:\n  b: 1\n  c:\n    d: [x]\ne: 2",
    "# lead\na: 1   # trailing\n\n\nb: 'q # not a comment'",
]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_resolves_as_pyyaml(text):
    assert load(text) == yaml.safe_load(text)


BAD = {
    "anchor": "a: &x 1", "alias": "a: *x", "tag": "a: !!str 1",
    "block literal": "a: |\n  x", "block folded": "a: >\n  x",
    "flow mapping": "a: {b: 1}", "block sequence": "a:\n  - 1",
    "two documents": "a: 1\n---\nb: 2", "tab": "a:\n\tb: 1",
    "timestamp": "a: 2001-12-14", "multi-line plain": "a: x\n  y",
    "multi-line flow": "a: [1,\n  2]", "directive": "%YAML 1.1\na: 1",
}


@pytest.mark.parametrize("what", sorted(BAD))
def test_reader_raises_naming_the_line(what):
    with pytest.raises(YAMLSubsetError, match=r"line \d+"):
        load(BAD[what])


def _asdict(cfg):
    return dataclasses.asdict(cfg)


OVERRIDES = [
    [],
    ["dataset", "synthetic", "H", "64", "train.lr", "1e-3", "perturb", "0",
     "test.input_view", "0,7", "test.target_view", "3,", "compact_ratio",
     "None", "exp_name", "1,2", "voxel_size", "[0.01, 0.02, 0.03]",
     "white_bkgd", "true", "train.scheduler.end_lr", "2e-6"],
    ["dataset", "h36m", "train.epoch", "7", "lpips_weight", "1"],
]


@pytest.mark.parametrize("name", FILES)
@pytest.mark.parametrize("opts", range(len(OVERRIDES)))
def test_files_merge_as_the_jax_package_merges_them(name, opts):
    opts = OVERRIDES[opts]
    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    got = _asdict(Config.from_yaml(path, opts))
    d = _yaml(name)
    if "dataset_variant" in d:
        # the JAX package's from_yaml refuses its own performance and
        # reconstruction files on this key; the port ignores it, and merges
        # the rest as the JAX package does
        with pytest.raises(KeyError, match="dataset_variant"):
            JConfig.from_yaml(path)
        del d["dataset_variant"]
        want = _asdict(JConfig().merge_dict(d).merge_opts(opts))
    else:
        want = _asdict(JConfig.from_yaml(path, opts))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
        assert type(got[k]) is type(want[k]), k
    if name == "train_or_eval":
        assert got["train"]["lr"] == (1e-3 if "train.lr" in opts else 7e-4)
        assert got["dataset"] == ("synthetic" if "synthetic" in opts
                                  else "zju")


@pytest.mark.parametrize("opts,exc", [
    (["no_such_key", "1"], KeyError), (["train.no_such", "1"], KeyError),
    (["H", "abc"], TypeError), (["test.input_view", "3"], TypeError),
    (["train", "1"], TypeError), (["white_bkgd", "maybe"], TypeError),
])
def test_merge_errors_as_the_jax_package(opts, exc):
    with pytest.raises(exc):
        JConfig().merge_opts(opts)
    with pytest.raises(exc):
        Config().merge_opts(opts)


def test_every_jax_key_is_classed():
    def flat(c, p=""):
        out = {}
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            out.update(flat(v, p + f.name + ".") if dataclasses.is_dataclass(v)
                       else {p + f.name: v})
        return out

    jkeys = flat(JConfig())
    assert tconfig.KEY_CLASSES.keys() == jkeys.keys()
    assert tconfig.flat_keys() == jkeys  # same defaults
    assert set(tconfig.KEY_CLASSES.values()) == {"honoured", "tpu_only",
                                                "unused"}
    for group in (tconfig.TPU_ONLY_KEYS, tconfig.UNUSED_KEYS,
                  tconfig.REFUSED):
        assert set(group) <= jkeys.keys()
    assert not tconfig.TPU_ONLY_KEYS & tconfig.UNUSED_KEYS
    # a refused key is one the port reads, at the values it runs
    assert all(tconfig.KEY_CLASSES[k] == "honoured" for k in tconfig.REFUSED)
    for k, (ok, _) in tconfig.REFUSED.items():
        assert jkeys[k] in ok, k  # the defaults run


REFUSE = [("compute_dtype", "float16", "float32 or bfloat16"),
          ("network", "other", "transhuman"), ("renderer", "other", "clight"),
          ("trainer", "other", "clight"), ("evaluator", "other", "if_nerf"),
          ("visualizer", "other", "perform"), ("vit_variant", "huge", "tiny"),
          ("run_mode", "serve", "train or test")]


@pytest.mark.parametrize("key,value,why", REFUSE)
def test_values_the_port_cannot_run_are_refused_by_name(key, value, why):
    cfg = Config().merge_opts([key, value])
    with pytest.raises(ValueError, match=rf"{key} .*{why}"):
        tconfig.check_supported(cfg)
    with pytest.raises(ValueError, match=key):
        common.parse_args([key, value])


def test_dataset_zju_is_refused_where_a_dataset_is_built():
    """zju is no longer refused: without its data on disk the loader fails
    by name; an unknown dataset is refused; synthetic builds."""
    cfg = Config().merge_opts(["data_root", "/nonexistent/zju"])
    assert "zju" in tconfig.DATASETS and cfg.dataset == "zju"
    assert tconfig.check_supported(cfg) is cfg
    with pytest.raises(FileNotFoundError, match="no annots.npy"):
        common.make_dataset(cfg, "train")
    with pytest.raises(ValueError, match="unknown dataset"):
        common.make_dataset(Config().merge_opts(["dataset", "nope"]), "test")
    data = common.make_dataset(Config().merge_opts(
        ["dataset", "synthetic", "H", "32", "W", "32", "num_class", "8"]),
        "test")
    assert data.hw == (16, 16)


def test_non_patch_sampling_is_accepted_and_depth_vizmap_refused():
    """Non-patch sampling, depth_map and depth_vizmap alone, and (since
    visibility from depth maps is ported) the two together are accepted;
    depth_root, which that mode reads, is honoured."""
    cfg = Config().merge_opts(["patch.use_patch_sampling", "False"])
    assert tconfig.check_supported(cfg) is cfg
    for opts in (["depth_map", "True"], ["depth_vizmap", "True"]):
        cfg = Config().merge_opts(opts)
        assert tconfig.check_supported(cfg) is cfg
    cfg = Config().merge_opts(["depth_map", "True", "depth_vizmap", "True",
                               "depth_root", "/data/depth"])
    assert tconfig.check_supported(cfg) is cfg
    assert cfg.depth_root == "/data/depth"
    for key in ("data_root", "rasterize_root", "rot_ratio", "vertices",
                "params", "rasterize", "jitter", "N_rand",
                "body_sample_ratio", "face_sample_ratio",
                "patch.sample_subject_ratio", "test.target_view",
                "test.mode", "time_steps", "depth_map", "depth_vizmap",
                "depth_root"):
        assert tconfig.KEY_CLASSES[key] == "honoured", key


def test_tpu_only_keys_warn_and_are_kept(capsys):
    """pad_bucket warns; remat, which the port honours, does not."""
    cfg = Config().merge_opts(["pad_bucket", "64", "remat", "True"])
    assert (cfg.pad_bucket, cfg.remat) == (64, True)
    err = capsys.readouterr().err
    assert "'pad_bucket' steers the TPU package only" in err
    assert "'remat'" not in err
    assert tconfig.KEY_CLASSES["remat"] == "honoured"
    Config().merge_opts(["H", "64"])
    assert "steers" not in capsys.readouterr().err


SMALL = ["dataset", "synthetic", "H", "64", "W", "64", "num_class", "20",
         "vit_depth", "1", "N_samples", "8", "patch.size", "6",
         "patch.N_patches", "2"]


@pytest.mark.parametrize("key,value", [
    ("cull_radii", "radii.npz"), ("train.cull", "True"),
    ("train.batch_size", "2"), ("train.accum_steps", "2"), ("remat", "True"),
])
def test_train_and_cull_keys_reach_the_pipeline_and_the_step(key, value,
                                                            tmp_path):
    """Each key merges, passes check_supported, is honoured, and reaches
    the pipeline or the step of the train entry point on the CPU."""
    import torch

    from transhuman_tpu_torch.cli.train import build_trainer

    radii = np.linspace(0.03, 0.1, 6890, dtype=np.float32)
    if key == "cull_radii":
        value = str(tmp_path / value)
        np.savez(value, radii=radii)
    opts = SMALL + [key, value]
    if key == "train.accum_steps":
        opts += ["train.batch_size", "2"]
    cfg = tconfig.check_supported(Config().merge_opts(opts))
    assert tconfig.KEY_CLASSES[key] == "honoured"
    state, step_fn, data, pipe = build_trainer(cfg, torch.device("cpu"))
    assert (pipe.vertex_radii is not None) == (key == "cull_radii")
    if key == "cull_radii":
        np.testing.assert_array_equal(pipe.vertex_radii.numpy(), radii)
    assert pipe.train_cull == (key == "train.cull")
    assert pipe.remat == (key == "remat")
    batch = [data.get_train_sample(i) for i in range(cfg.train.batch_size)]
    seen = []
    render = pipe.render_train_batch
    pipe.render_train_batch = lambda f, *a, **kw: (seen.append(len(f)),
                                                   render(f, *a, **kw))[1]
    stats = step_fn(state, batch, 0)
    assert np.isfinite(stats["loss"])
    # one forward of the whole batch, or one per microbatch
    assert seen == ([1, 1] if key == "train.accum_steps"
                    else [cfg.train.batch_size])
    assert ("cull_survivors" in stats) == (key == "train.cull")


@pytest.mark.parametrize("entry", ["train", "run", "serve"])
def test_entry_points_take_cfg_file(entry):
    """--cfg_file and overrides give Config.from_yaml's config on the
    train, run and serve entry points."""
    import argparse

    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.cli import train as train_cli

    path = os.path.join(ROOT, "configs", "train_or_eval.yaml")
    argv = ["--cfg_file", path, "dataset", "synthetic", "H", "64"]
    want = Config.from_yaml(path, ["dataset", "synthetic", "H", "64"])
    if entry == "serve":
        p = argparse.ArgumentParser()
        common.add_config_args(p)
        cfg = common.load_config(p.parse_args(argv))
    else:
        mod = train_cli if entry == "train" else run_cli
        args, cfg = mod.parse_args(["--device", "cpu", *argv])
        assert args.device == "cpu" and args.cfg_file == path
    assert cfg == want
    assert cfg.compute_dtype == "bfloat16" and cfg.H == 64
