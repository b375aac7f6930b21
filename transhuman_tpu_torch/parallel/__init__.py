"""Data parallelism across processes (counterpart of
transhuman_tpu/parallel/): the process group torchrun describes, the data
mesh over its ranks, and the sharding of batches and frames; infer.py
splits one frame's rays over the devices of one process."""

from .mesh import (
    DataMesh,
    all_gather_host,
    barrier,
    frame_shard,
    gather_positioned,
    init_distributed,
    make_mesh,
    merge_positioned,
    process_shard,
    shutdown,
)

__all__ = ["DataMesh", "all_gather_host", "barrier", "frame_shard",
           "gather_positioned", "init_distributed", "make_mesh",
           "merge_positioned", "process_shard", "shutdown"]
