"""Parallelism across processes (counterpart of transhuman_tpu/parallel/):
the process group torchrun describes, the data mesh over its ranks and the
sharding of batches and frames (mesh.py), the ('data', 'model') mesh and
tensor-parallel training (tp.py), the pipelined TransHE (pp.py); infer.py
splits one frame's rays over the devices of one process."""

from .mesh import (
    DataMesh,
    ProcessMesh,
    TPMesh,
    all_gather_host,
    barrier,
    frame_shard,
    gather_positioned,
    init_distributed,
    make_mesh,
    make_process_mesh,
    make_tp_mesh,
    make_tp_train_mesh,
    merge_positioned,
    process_shard,
    shutdown,
)
from .pp import (
    make_pp_mesh,
    make_pp_vit_apply,
    shard_pp_params,
    stack_block_params,
    unstack_block_params,
)
from .tp import (
    make_tp_train_step,
    match_tp_axes,
    shard_model_,
    shard_train_state_,
    tp_param_specs,
)

__all__ = ["DataMesh", "ProcessMesh", "TPMesh", "all_gather_host", "barrier",
           "frame_shard", "gather_positioned", "init_distributed",
           "make_mesh", "make_pp_mesh", "make_pp_vit_apply",
           "make_process_mesh", "make_tp_mesh", "make_tp_train_step",
           "make_tp_train_mesh", "match_tp_axes", "merge_positioned",
           "process_shard", "shard_model_", "shard_pp_params",
           "shard_train_state_", "shutdown", "stack_block_params",
           "tp_param_specs", "unstack_block_params"]
