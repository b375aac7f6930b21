"""Tensor-parallel training over a ('data', 'model') mesh (counterpart of
transhuman_tpu/parallel/tp.py): TransHE's blocks sharded Megatron-style
over the model axis, the rest of the network replicated, the batch split
over the data axis.

Layout (state-dict names, torch (out, in) weights; first match wins,
everything else replicated):
  * ``attn.qkv``  weight and bias, rows   column-parallel, by whole heads
  * ``attn.proj`` weight, columns         row-parallel, bias replicated
  * ``mlp.fc1``   weight and bias, rows   column-parallel
  * ``mlp.fc2``   weight, columns         row-parallel, bias replicated

The column -> row pairing keeps the activations inside a block half
sharded: a column-parallel layer's input passes ``_CopyIn`` (identity
forward, all-reduce of its gradient backward), a row-parallel layer's
partial output passes ``_ReduceOut`` (all-reduce forward, identity
backward) and takes its bias once, after the reduce.  That is one
all-reduce per block half forward and one backward, 4 x depth for each
TransHE call (one a sample) of a step, counted and timed in the model
axis's ``log``.

**The attention split differs from JAX's on purpose.**  JAX's
``P(None, 'model')`` on the (D, 3D) qkv kernel cuts the 3D columns into
contiguous blocks and GSPMD reshards around the head reshape.  A split
written by hand must be by whole heads: each rank takes the q, k and v
rows of its ``num_heads / n_model`` heads and attends over them with no
gather.  So attention is sharded when ``num_heads % n_model == 0`` and
replicated otherwise, and the MLP when ``4D % n_model == 0``: TransHE
tiny (3 heads) at n_model 2 keeps attention replicated and shards the
MLP, where JAX shards both.  The numbers are the same; only the memory
differs.

The optimizer only ever sees a rank's shards, so Adam's moments shard with
their parameters (JAX ``shard_train_state``); the per-element gradient
clip needs no collective.  A replicated leaf's gradient is equal on the
model ranks in exact arithmetic (they hold the same all-reduced
activations and cotangents), but each rank computes it on its own, and on
the card some kernels (atomic adds in backward passes) do not give the
same bits twice: after one step the ranks' replicated weights differed
(``chip_smoke.py`` phase l1).  So the replicated leaves are averaged over
every rank, the sharded ones over the data axis (``tp_groups``): the same
count of gradient collectives as a data-parallel step, with the
replicated leaves' bytes crossing the model axis too.  JAX's GSPMD keeps
one logical value of each replicated leaf, which this restores.
"""

from __future__ import annotations

import hashlib
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import linear
from ..train.step import _Timer, make_train_step
from .mesh import Axis, TPMesh

# (state-dict name pattern, sharded dim of the torch tensor, the q/k/v
# blocks that dim holds, whether the split is by heads)
_TP_RULES = (
    (r"attn\.qkv\.weight$", 0, 3, True),
    (r"attn\.qkv\.bias$", 0, 3, True),
    (r"attn\.proj\.weight$", 1, 1, True),
    (r"mlp\.fc1\.weight$", 0, 1, False),
    (r"mlp\.fc1\.bias$", 0, 1, False),
    (r"mlp\.fc2\.weight$", 1, 1, False),
)


@dataclass(frozen=True)
class TPSpec:
    """How a tensor is sharded: along ``dim``, which holds ``parts`` equal
    blocks (q, k and v), each cut into n contiguous pieces."""

    dim: int
    parts: int = 1


def match_tp_axes(name: str, shape, n_shard: int, num_heads: int,
                  dim_offset: int = 0) -> Optional[TPSpec]:
    """The one rule match and divisibility check, shared by
    ``tp_param_specs`` (tensors as they are, dim_offset 0) and
    ``pp.shard_pp_params`` (stacked (stage, block, ...) leaves, dim_offset
    2): the spec of ``name``, or None (replicated)."""
    for pat, dim, parts, by_heads in _TP_RULES:
        if re.search(pat, name):
            ok = (num_heads % n_shard == 0 if by_heads
                  else shape[dim_offset + dim] % n_shard == 0)
            return TPSpec(dim_offset + dim, parts) if ok else None
    return None


def tp_param_specs(sd: dict, n_model: int, num_heads: int) -> dict:
    """{name: TPSpec or None} of every entry of a reference-layout state
    dict: the rules where the split divides, replicated otherwise."""
    return {k: match_tp_axes(k, tuple(v.shape), n_model, num_heads)
            for k, v in sd.items()}


def shard_tensor(t, spec: TPSpec, rank: int, n: int):
    """Rank ``rank``'s piece of ``t`` out of n."""
    d = spec.dim
    return t.unflatten(d, (spec.parts, -1)).chunk(n, d + 1)[rank] \
        .flatten(d, d + 1).contiguous()


def unshard_tensors(pieces, spec: TPSpec):
    """The whole tensor from every rank's piece, in rank order."""
    d = spec.dim
    return torch.cat([p.unflatten(d, (spec.parts, -1)) for p in pieces],
                     dim=d + 1).flatten(d, d + 1)


def shard_state_dict(sd: dict, specs: dict, axis: Axis) -> dict:
    """This model rank's shards of a reference-layout state dict."""
    return {k: (shard_tensor(v, specs[k], axis.rank, axis.size)
                if specs.get(k) is not None else v) for k, v in sd.items()}


# ------------------------------------------------------------ collectives
def _all_reduce(t, axis: Axis):
    """The sum of t over the model axis, in float32, returned in t's dtype
    (a fresh tensor); counted and timed (CUDA events on the card, the host
    clock on the CPU) in the axis's log."""
    buf = torch.empty_like(t, dtype=torch.float32,
                           memory_format=torch.contiguous_format).copy_(t)
    timer = _Timer(buf.device)
    timer.mark(0)
    dist.all_reduce(buf, group=axis.group)
    timer.mark(1)
    axis.log.count += 1
    axis.log.timers.append(timer)
    return buf.to(t.dtype)


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceOut(torch.autograd.Function):
    """The sum over the model axis forward; the gradient as it is."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def column_linear(x, weight, bias, dtype, axis: Axis):
    """A column-parallel Linear in ``dtype``: the full input, this rank's
    output columns."""
    return linear(_CopyIn.apply(x, axis), weight, bias, dtype)


def row_linear(x, weight, bias, dtype, axis: Axis):
    """A row-parallel Linear in ``dtype``: this rank's input columns, the
    partial products summed over the model axis in float32, then the
    (replicated) bias, then the cast."""
    y = _ReduceOut.apply(linear(x, weight, None, dtype).float(), axis)
    return (y + bias.float()).to(dtype)


class ColumnParallelLinear(nn.Module):
    """This rank's rows of a Linear's weight and bias."""

    def __init__(self, weight, bias, axis: Axis):
        super().__init__()
        self.weight = nn.Parameter(weight.detach().clone())
        self.bias = nn.Parameter(bias.detach().clone())
        self.axis = axis

    def forward(self, x, dtype):
        return column_linear(x, self.weight, self.bias, dtype, self.axis)


class RowParallelLinear(nn.Module):
    """This rank's columns of a Linear's weight, and its whole bias."""

    def __init__(self, weight, bias, axis: Axis):
        super().__init__()
        self.weight = nn.Parameter(weight.detach().clone())
        self.bias = nn.Parameter(bias.detach().clone())
        self.axis = axis

    def forward(self, x, dtype):
        return row_linear(x, self.weight, self.bias, dtype, self.axis)


# ------------------------------------------------------ the sharded model
@dataclass(frozen=True)
class Sharding:
    """What shard_model_ did: the model axis and the spec of every sharded
    state-dict entry."""

    axis: Axis
    specs: Dict[str, TPSpec]


def sharding_of(net: nn.Module) -> Optional[Sharding]:
    return getattr(net, "_tp_sharding", None)


def _vit(net: nn.Module):
    return net.ViT if hasattr(net, "ViT") else net


def shard_model_(net: nn.Module, axis: Axis) -> nn.Module:
    """Swap the TransHE blocks' Linears of ``net`` (a TransHumanNet or a
    TransHE) for parallel ones over ``axis``, each holding only this
    rank's shard; in place, keeping every parameter's name and order.
    Nothing changes on an axis of size 1."""
    if sharding_of(net) is not None:
        raise ValueError("the model is sharded already")
    vit = _vit(net)
    prefix = "ViT." if vit is not net else ""
    specs = {}
    if axis.size > 1:
        for i, blk in enumerate(vit.blocks):
            for part, attr in (("attn", "qkv"), ("attn", "proj"),
                               ("mlp", "fc1"), ("mlp", "fc2")):
                owner = getattr(blk, part)
                lin = getattr(owner, attr)
                base = f"{prefix}blocks.{i}.{part}.{attr}"
                ws = match_tp_axes(base + ".weight", tuple(lin.weight.shape),
                                   axis.size, vit.num_heads)
                if ws is None:
                    continue
                bs = match_tp_axes(base + ".bias", tuple(lin.bias.shape),
                                   axis.size, vit.num_heads)
                w = shard_tensor(lin.weight.data, ws, axis.rank, axis.size)
                specs[base + ".weight"] = ws
                if bs is not None:  # column-parallel: bias sharded too
                    b = shard_tensor(lin.bias.data, bs, axis.rank, axis.size)
                    specs[base + ".bias"] = bs
                    setattr(owner, attr, ColumnParallelLinear(w, b, axis))
                else:
                    setattr(owner, attr,
                            RowParallelLinear(w, lin.bias.data, axis))
    net._tp_sharding = Sharding(axis, specs)
    return net


def _gather(t, spec: TPSpec, axis: Axis):
    """The whole tensor from every model rank's piece of it, on the CPU,
    over the axis's gloo group (every model rank must call it)."""
    piece = t.detach().cpu().contiguous()
    pieces = [torch.empty_like(piece) for _ in range(axis.size)]
    dist.all_gather(pieces, piece, group=axis.host_group)
    return unshard_tensors(pieces, spec)


def gather_state_dict(net: nn.Module) -> dict:
    """The reference-layout state dict of a sharded model, on the CPU
    (every model rank must call it); a model not sharded gives its own."""
    sh = sharding_of(net)
    sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    if sh is None or not sh.specs:
        return sd
    return {k: (_gather(v, sh.specs[k], sh.axis) if k in sh.specs else v)
            for k, v in sd.items()}


def _param_names(state) -> list:
    """The parameter name of each index of the optimizer's state dict."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups
            for p in g["params"]]


def gather_optimizer_state(state) -> dict:
    """The optimizer's state dict with each sharded parameter's moments
    gathered, as one process would hold it (every model rank must call
    it)."""
    osd = state.optimizer.state_dict()
    sh = sharding_of(state.model)
    if sh is None or not sh.specs:
        return osd
    names = _param_names(state)
    params = dict(state.model.named_parameters())
    out = {}
    for i, st in osd["state"].items():
        name = names[i]
        spec = sh.specs.get(name)
        out[i] = {k: (_gather(v, spec, sh.axis)
                      if spec is not None and torch.is_tensor(v)
                      and v.shape == params[name].shape else v)
                  for k, v in st.items()}
    return {"state": out, "param_groups": osd["param_groups"]}


def shard_train_state_(state, axis: Axis):
    """Shard a TrainState built and restored on the whole model: the model
    (shard_model_), then the optimizer's parameters and their moments
    (each tensor shaped like its parameter is cut as the parameter is), in
    place; the scheduler keeps its optimizer."""
    before = list(state.model.named_parameters())
    shard_model_(state.model, axis)
    specs = sharding_of(state.model).specs
    after = dict(state.model.named_parameters())
    swap = {id(p): after[n] for n, p in before}
    full = {id(p): (n, tuple(p.shape)) for n, p in before}
    opt = state.optimizer
    moved = defaultdict(dict)
    for p, st in opt.state.items():
        name, shape = full[id(p)]
        spec = specs.get(name)
        moved[swap[id(p)]] = {
            k: (shard_tensor(v, spec, axis.rank, axis.size)
                if spec is not None and torch.is_tensor(v)
                and tuple(v.shape) == shape else v)
            for k, v in st.items()}
    for g in opt.param_groups:
        g["params"] = [swap[id(p)] for p in g["params"]]
    opt.state = moved
    return state


def vit_bytes(state) -> dict:
    """This rank's TransHE parameter bytes and its optimizer moments'."""
    vit = _vit(state.model)
    ps = list(vit.parameters())
    moments = sum(v.numel() * v.element_size() for p in ps
                  for v in state.optimizer.state.get(p, {}).values()
                  if torch.is_tensor(v) and v.shape == p.shape)
    return {"vit_param_bytes": sum(p.numel() * p.element_size() for p in ps),
            "vit_moment_bytes": moments}


def _digest(named) -> str:
    h = hashlib.sha256()
    for name, p in sorted(named):
        h.update(name.encode())
        h.update(p.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def vit_digest(net: nn.Module) -> str:
    """sha256 of this rank's TransHE parameters' bytes, in name order."""
    return _digest(_vit(net).named_parameters())


def replicated_digest(net: nn.Module) -> str:
    """sha256 of the parameters no rank shards, in name order: equal on
    every model rank while their computations are bit-equal."""
    sh = sharding_of(net)
    specs = sh.specs if sh is not None else {}
    return _digest((n, p) for n, p in net.named_parameters()
                   if n not in specs)


def tp_groups(net: nn.Module, mesh: TPMesh):
    """The tensor-parallel step's reduction groups
    (``train.step._average_over_ranks``): each parameter that no rank
    shards averaged over every rank (the data ranks' samples differ; the
    model ranks' copies agree but for rounding), each shard over the data
    axis; the stats over every rank, each sample held by n_model ranks."""
    def groups(params):
        sh = sharding_of(net)
        cut = {id(p) for n, p in net.named_parameters()
               if sh is not None and n in sh.specs}
        return ([(mesh.world, [p for p in params if id(p) not in cut]),
                 (mesh.data, [p for p in params if id(p) in cut])],
                mesh.world, mesh.model.size)

    return groups


def make_tp_train_step(pipe, mesh, clip_value: float = 40.0,
                       l2_weight: float = 1.0, perturb: bool = True,
                       accum_steps: int = 1, lpips_fn=None,
                       lpips_weight: float = 0.1, patch_mode: bool = True):
    """The train step over a TPMesh, with make_train_step's contract:
    (state, batch, seed) -> stats, batch this data rank's B samples.  The
    model must be sharded over ``mesh.model`` (shard_model_ or
    shard_train_state_).  The data axis runs make_train_step's step as it
    stands: sample i folds the data index's global sample ``data.rank * B
    + i`` into the seed (JAX: the same per-sample keys), BatchNorm pools
    over the data group (the model ranks of one data index hold the same
    samples, so no sample counts twice); the gradients and stats are
    reduced over ``tp_groups``.  ``step.comm`` adds the model axis's
    all-reduce count and ms of the last step."""
    sh = sharding_of(pipe.model)
    if mesh.model.size > 1 and (sh is None or sh.axis.ranks
                                != mesh.model.ranks):
        raise ValueError(
            "the TP step needs the model sharded over the mesh's model axis "
            f"{mesh.model.ranks}: call shard_model_(net, mesh.model) first")
    inner = make_train_step(pipe, clip_value, l2_weight, perturb,
                            accum_steps, lpips_fn, lpips_weight,
                            patch_mode, mesh=mesh.data,
                            reduce_groups=(tp_groups(pipe.model, mesh)
                                           if mesh.world.distributed
                                           else None))

    log = (sh.axis if sh is not None else mesh.model).log

    def step(state, batch, seed=None) -> dict:
        log.reset()
        stats = inner(state, batch, seed)
        step.comm = dict(inner.comm or {}, model_allreduce_count=log.count,
                         model_allreduce_ms=log.ms())
        return stats

    step.comm = None
    return step
