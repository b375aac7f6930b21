"""Hand-written CUDA kernels of the render and train paths and their launch
counters.

Importing this package builds nothing: ``build.library()`` compiles
``csrc/*.cu`` with nvcc at the first launch.
"""

from __future__ import annotations

from .cull import min_excess2_cuda
from .dparf import dparf_bf16_cuda, dparf_cuda
from .gather import feature_gather_cuda, feature_sample_bf16_cuda
from .scatter import dfeat_scatter_bf16_cuda, dfeat_scatter_cuda

# the float32 forms, then the bf16 forms of K2, K3 and K4's sampling form
_WRAPPERS = {"min_excess2": min_excess2_cuda, "dparf": dparf_cuda,
             "dfeat_scatter": dfeat_scatter_cuda,
             "feature_gather": feature_gather_cuda,
             "dparf_bf16": dparf_bf16_cuda,
             "dfeat_scatter_bf16": dfeat_scatter_bf16_cuda,
             "feature_sample_bf16": feature_sample_bf16_cuda}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts():
    for fn in _WRAPPERS.values():
        fn.launches = 0
