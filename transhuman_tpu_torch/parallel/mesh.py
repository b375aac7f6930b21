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

``make_process_mesh`` lays the ranks out on named axes, the last axis the
minor one (JAX ``Mesh`` over ``devices.reshape(...)``): world rank r =
((c0 * n1) + c1) * n2 + ... for coordinates (c0, c1, ...).  Each axis of a
rank is the group of the ranks that differ from it in that coordinate
only.  ``make_tp_mesh(n_data, n_model)`` is the ('data', 'model') mesh of
tensor-parallel training (transhuman_tpu/parallel/tp.py::make_tp_mesh):
its data axis is a ``DataMesh``, so the data-parallel step runs over it
unchanged, and its model axis carries the Megatron collectives.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

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


@dataclass
class CollectiveLog:
    """The collectives run over an axis since the last reset: their count
    and each one's timer (anything with an ``ms()``)."""

    count: int = 0
    timers: list = field(default_factory=list)

    def reset(self):
        self.count, self.timers = 0, []

    def ms(self) -> float:
        return sum(t.ms() for t in self.timers)


@dataclass(frozen=True)
class Axis:
    """One named axis of a process mesh as one rank sees it: its
    coordinate, the axis size, the group of the ranks along it (None when
    the size is 1), that group's gloo twin for host objects, the world
    ranks along it in axis order, and the log of the collectives run over
    it."""

    name: str
    rank: int = 0
    size: int = 1
    group: Optional[Any] = None
    host_group: Optional[Any] = None
    ranks: Tuple[int, ...] = (0,)
    log: CollectiveLog = field(default_factory=CollectiveLog, compare=False,
                               repr=False)

    def as_data_mesh(self) -> DataMesh:
        return DataMesh(self.rank, self.size, self.group, self.host_group)


@dataclass(frozen=True)
class ProcessMesh:
    """Named axes over the ranks of the process group (JAX ``Mesh``)."""

    axes: Tuple[Axis, ...]

    @property
    def shape(self) -> dict:
        return {a.name: a.size for a in self.axes}

    def __getitem__(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"axis {name!r} not in mesh {self.shape}")


def make_process_mesh(names: Sequence[str], sizes: Sequence[int]
                      ) -> ProcessMesh:
    """The mesh of axes ``names`` with ``sizes`` over every rank of the
    process group, the last axis minor.  Every rank creates every group of
    every axis, in one order (``dist.new_group`` is collective), with a
    gloo twin beside each when the group's backend is not gloo.  The world
    size must be the product of the sizes (ValueError with the counts, as
    the JAX mesh's "need ... devices")."""
    names, sizes = tuple(names), tuple(int(n) for n in sizes)
    need = int(np.prod(sizes)) if sizes else 1
    world = dist.get_world_size() if dist.is_initialized() else 1
    if need != world:
        raise ValueError(
            f"need {need} processes for mesh {dict(zip(names, sizes))}, "
            f"have {world}: launch {need} ranks")
    me = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(need).reshape(sizes)
    coords = np.unravel_index(me, sizes)
    twin = (dist.is_initialized()
            and dist.get_backend() != dist.Backend.GLOO)
    axes = []
    for i, name in enumerate(names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        mine, group, host = None, None, None
        for line in lines:
            ranks = tuple(int(r) for r in line)
            g = h = None
            if sizes[i] > 1:
                g = dist.new_group(list(ranks))
                h = dist.new_group(list(ranks), backend="gloo") if twin \
                    else g
            if me in ranks:
                mine, group, host = ranks, g, h
        axes.append(Axis(name, int(coords[i]), sizes[i], group, host, mine))
    return ProcessMesh(tuple(axes))


@dataclass(frozen=True)
class TPMesh:
    """The ('data', 'model') mesh of tensor-parallel training as one rank
    sees it: ``data`` the DataMesh of the ranks that share its model
    index (its rank the data index), ``model`` the axis of the n_model
    consecutive ranks that share its data index, ``world`` every rank
    (barriers, host gathers; world rank 0 records and writes)."""

    data: DataMesh
    model: Axis
    world: DataMesh


def make_tp_mesh(n_data: int, n_model: int) -> TPMesh:
    """The ('data', 'model') mesh, 'model' the minor axis as in JAX
    (world rank r = d * n_model + m).  The world size must be n_data *
    n_model."""
    pm = make_process_mesh(("data", "model"), (n_data, n_model))
    return TPMesh(pm["data"].as_data_mesh(), pm["model"], make_mesh())


def make_tp_train_mesh(n_data: int, n_model: int) -> TPMesh:
    """The TPMesh a train run takes from ``mesh_axis_data`` and
    ``mesh_axis_model`` > 1: world / n_model data indices.  The world size
    must be divisible by n_model, and n_data must be 0 or world / n_model
    (ValueError naming the values)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_model:
        raise ValueError(
            f"mesh_axis_model={n_model} does not divide the world of {world} "
            f"process(es): launch a multiple of {n_model} ranks under "
            "torchrun (one process drives one card)")
    if n_data and n_data != world // n_model:
        raise ValueError(
            f"mesh_axis_data={n_data} but the world of {world} process(es) "
            f"at mesh_axis_model={n_model} has {world // n_model} data "
            f"indices: mesh_axis_data must be 0 or {world // n_model}")
    return make_tp_mesh(world // n_model, n_model)


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
