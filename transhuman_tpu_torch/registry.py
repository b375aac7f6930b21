"""Name -> constructor registries of the config's plugin fields
(counterpart of transhuman_tpu/registry.py).

The reference loads the modules its config names (``imp.load_source`` in
its make_dataset, make_network, make_renderer, make_trainer,
make_evaluator and make_visualizer); here an implementation registers
under a short name and ``cfg.dataset``, ``cfg.network``, ``cfg.renderer``,
``cfg.trainer``, ``cfg.evaluator`` and ``cfg.visualizer`` pick one by name.
The port's own entries register where they are defined:

* ``DATASETS``: ``synthetic`` (data/synthetic.py), ``zju`` (data/zju.py),
  each ``(cfg, split, smpl=None) -> dataset``;
* ``NETWORKS``: ``transhuman`` (models/network.py), ``(cfg) -> model``;
* ``RENDERERS``: ``clight`` (render/pipeline.py), ``(model, cluster,
  canonical_verts, cfg, device, pe_table=None, vertex_radii=None) -> pipe``;
* ``TRAINERS``: ``clight`` (train/step.py), ``make_train_step``'s
  signature;
* ``EVALUATORS``: ``if_nerf`` (evals/evaluator.py), ``Evaluator``'s;
* ``VISUALIZERS``: ``perform`` (viz/perform.py), ``PerformVisualizer``'s.

A user's own implementation registers the same way before an entry point
runs; an unknown name is a KeyError that lists the known names.
"""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str):
        def deco(fn):
            if name in self._entries:
                raise KeyError(f"{self.kind} {name!r} already registered")
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        if name not in self._entries:
            raise KeyError(
                f"Unknown {self.kind} {name!r}; known: {sorted(self._entries)}"
            )
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries


DATASETS = Registry("dataset")
NETWORKS = Registry("network")
RENDERERS = Registry("renderer")
TRAINERS = Registry("trainer")
EVALUATORS = Registry("evaluator")
VISUALIZERS = Registry("visualizer")

# the config field that names an entry of each registry
PLUGIN_FIELDS = {"dataset": DATASETS, "network": NETWORKS,
                 "renderer": RENDERERS, "trainer": TRAINERS,
                 "evaluator": EVALUATORS, "visualizer": VISUALIZERS}


def load_builtins():
    """Import the modules that register the port's own entries."""
    from .data import synthetic, zju  # noqa: F401
    from .evals import evaluator  # noqa: F401
    from .models import network  # noqa: F401
    from .render import pipeline  # noqa: F401
    from .train import step  # noqa: F401
    from .viz import perform  # noqa: F401


def check_plugins(cfg):
    """cfg, or the registry's KeyError for the first plugin field whose
    name no implementation registered."""
    load_builtins()
    for key, registry in PLUGIN_FIELDS.items():
        registry.get(getattr(cfg, key))
    return cfg
