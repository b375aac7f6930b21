"""The process group, the data mesh over its ranks, and batch and frame
sharding (counterpart of transhuman_tpu/parallel/mesh.py and
transhuman_tpu/cli/run.py::_frame_shard).

The JAX package runs one program over a ``Mesh(devices, ('data',))``,
spanning hosts after ``jax.distributed.initialize()``.  The port runs one
process per card, launched by torchrun, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
``MASTER_ADDR``/``MASTER_PORT`` (the ``env://`` rendezvous):

    torchrun --nproc_per_node N -m transhuman_tpu_torch.cli.train ...

``init_distributed`` joins that group (nothing without those variables) and
opens a gloo side group beside it, over which host metadata (frame
positions, per-frame metrics, shapes) travels as Python objects, so no
host value needs a CUDA tensor under NCCL.  ``make_mesh`` gives the
``DataMesh`` of the calling rank: its rank, the world size, the group the
train step's collectives run on, and the side group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch.distributed as dist

_HOST_GROUP = None  # the gloo side group of the group init_distributed joined


@dataclass(frozen=True)
class DataMesh:
    """The data axis as one rank sees it.  ``group`` is None for a process
    outside any process group (size 1, no collective runs)."""

    rank: int = 0
    size: int = 1
    group: Optional[Any] = None
    host_group: Optional[Any] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None


def init_distributed(backend: str = "nccl",
                     init_method: Optional[str] = None) -> bool:
    """Join the process group that RANK and WORLD_SIZE describe
    (``init_method`` default ``env://``: MASTER_ADDR and MASTER_PORT), and
    open the gloo side group.  Does nothing without those variables, or
    when a group is up already.  True when this call made the group."""
    global _HOST_GROUP
    if dist.is_initialized():
        return False
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    _HOST_GROUP = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo"))
    return True


def shutdown():
    """Leave the process group (init_distributed's), if one is up."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def make_mesh(n_data: int = 0) -> DataMesh:
    """The data mesh over every rank of the process group (a one-process
    mesh without one).  ``n_data`` is ``mesh_axis_data``: 0 means every
    rank; any other value must be the world size, since one process drives
    one card (the JAX ``make_mesh`` refuses more devices than it has)."""
    if not dist.is_initialized():
        rank, size, group, host = 0, 1, None, None
    else:
        rank, size = dist.get_rank(), dist.get_world_size()
        group, host = dist.group.WORLD, _HOST_GROUP or dist.group.WORLD
    if n_data and n_data != size:
        raise ValueError(
            f"mesh_axis_data={n_data} but the world has {size} process(es): "
            "one process drives one card, so mesh_axis_data must be 0 (every "
            f"rank) or {size} (launch as many ranks as the data axis)")
    return DataMesh(rank, size, group, host)


def barrier(mesh: DataMesh):
    """Wait for every rank (over the side group); nothing in one process."""
    if mesh.distributed:
        dist.barrier(group=mesh.host_group)


def process_shard(n_items: int, shuffle_rng=None,
                  mesh: Optional[DataMesh] = None) -> np.ndarray:
    """This rank's item indices, the DistributedSampler analog: a contiguous
    shard of the (optionally shuffled) range, padded by cycling so that
    every rank gets the same count, however few the items."""
    mesh = mesh or DataMesh()
    idx = np.arange(n_items)
    if shuffle_rng is not None:
        shuffle_rng.shuffle(idx)
    per = int(np.ceil(n_items / mesh.size))
    idx = np.resize(idx, per * mesh.size)
    return idx[mesh.rank * per:(mesh.rank + 1) * per]


def frame_shard(indices, mesh: Optional[DataMesh] = None):
    """(this rank's strided slice of the frame sequence, each frame's
    position in it).  One process: the identity."""
    mesh = mesh or DataMesh()
    idx = np.asarray(indices)
    return (idx[mesh.rank::mesh.size],
            np.arange(mesh.rank, idx.size, mesh.size))


def merge_positioned(values_by_rank, positions_by_rank) -> list:
    """The values of every rank in the order of their positions."""
    pairs = []
    for vals, pos in zip(values_by_rank, positions_by_rank):
        if len(vals) != len(pos):
            raise ValueError(f"{len(vals)} values vs {len(pos)} positions")
        pairs.extend(zip((int(p) for p in pos), vals))
    return [v for _, v in sorted(pairs, key=lambda pv: pv[0])]


def gather_positioned(values, positions,
                      mesh: Optional[DataMesh] = None) -> list:
    """Every rank's (value, position) pairs, gathered over the side group,
    as one list in position order: the list one process would have made.
    The ranks' counts may differ; every rank must call it."""
    vals = [float(v) for v in np.asarray(values, np.float64).reshape(-1)]
    pos = [int(p) for p in np.asarray(positions, np.int64).reshape(-1)]
    mesh = mesh or DataMesh()
    if not mesh.distributed or mesh.size == 1:
        return merge_positioned([vals], [pos])
    got = [None] * mesh.size
    dist.all_gather_object(got, (vals, pos), group=mesh.host_group)
    return merge_positioned([g[0] for g in got], [g[1] for g in got])


def all_gather_host(obj, mesh: DataMesh) -> list:
    """Each rank's picklable ``obj``, in rank order, over the side group."""
    if not mesh.distributed or mesh.size == 1:
        return [obj]
    got = [None] * mesh.size
    dist.all_gather_object(got, obj, group=mesh.host_group)
    return got
