"""The port's plugin registries (registry.py), after the JAX package's
tests/test_registry_routing.py: every plugin field of the repo's configs
resolves, an unknown name fails with the known names, and an entry a user
registers is the one the run entry point builds."""

import os

import numpy as np
import pytest
import torch

from transhuman_tpu import registry as jregistry
from transhuman_tpu_torch import registry
from transhuman_tpu_torch.cli import common
from transhuman_tpu_torch.cli import run as run_cli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.models.network import TransHumanNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cfg_file", [None, "train_or_eval.yaml",
                                      "performance.yaml",
                                      "reconstruction.yaml"])
def test_all_plugin_fields_resolve(cfg_file):
    path = cfg_file and os.path.join(ROOT, "configs", cfg_file)
    cfg = Config.from_yaml(path, [])
    assert registry.check_plugins(cfg) is cfg
    for key, reg in registry.PLUGIN_FIELDS.items():
        assert getattr(cfg, key) in reg, key
    assert "synthetic" in registry.DATASETS
    # the port registers the names the JAX package registers
    import transhuman_tpu.cli.common  # noqa: F401  (JAX registrations)
    import transhuman_tpu.data.synthetic  # noqa: F401
    import transhuman_tpu.evals.evaluator  # noqa: F401
    import transhuman_tpu.train.step  # noqa: F401
    import transhuman_tpu.viz.perform  # noqa: F401

    for key, reg in registry.PLUGIN_FIELDS.items():
        jreg = getattr(jregistry, key.upper() + "S")
        assert sorted(reg._entries) == sorted(jreg._entries), key


def test_unknown_plugin_name_fails_loudly():
    cfg = Config().merge_dict({"network": "resnerf", "num_class": 8})
    with pytest.raises(KeyError, match=r"Unknown network 'resnerf'; known: "
                                       r"\['transhuman'\]"):
        common.build_runtime(cfg, torch.device("cpu"))
    cfg = Config().merge_dict({"dataset": "h37m"})
    with pytest.raises(KeyError, match="Unknown dataset 'h37m'"):
        common.make_dataset(cfg, "test")
    with pytest.raises(KeyError, match="Unknown renderer 'nerf'"):
        run_cli.main(["--type", "evaluate", "--device", "cpu", "renderer",
                      "nerf"])
    with pytest.raises(KeyError, match="already registered"):
        registry.NETWORKS.register("transhuman")(TransHumanNet.from_config)


def test_a_registered_network_is_the_one_the_run_entry_point_builds(
        tmp_path):
    """A network registered under a new name is built by the run entry
    point when the config names it; its checkpoint loads strictly."""
    opts = ["dataset", "synthetic", "H", "64", "W", "64", "num_class", "8",
            "vit_depth", "1", "N_samples", "4", "test.frame_interval", "8",
            "result_dir", str(tmp_path / "res"),
            "kmeans_dir", str(tmp_path / "none")]
    cfg = Config().merge_opts(opts)
    net = TransHumanNet.from_config(cfg)
    ckpt = str(tmp_path / "w.pth")
    torch.save({"net": net.state_dict(), "epoch": 0}, ckpt)
    built = []

    @registry.NETWORKS.register("recording_net")
    def recording(cfg):
        model = TransHumanNet.from_config(cfg)
        built.append((cfg.network, model))
        return model

    try:
        summary = run_cli.main(["--type", "evaluate", "--device", "cpu",
                                "--weights", ckpt, *opts,
                                "network", "recording_net"])
    finally:
        registry.NETWORKS._entries.pop("recording_net")
    assert [name for name, _ in built] == ["recording_net"]
    model = built[0][1]
    for k, v in net.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert np.isfinite(summary["psnr"])
    assert "recording_net" not in registry.NETWORKS
