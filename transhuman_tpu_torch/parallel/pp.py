"""Pipeline-parallel TransHE over a ('pipe',) mesh, GPipe schedule
(counterpart of transhuman_tpu/parallel/pp.py).

TransHE's ``depth`` blocks split into ``n_stages`` contiguous stages:
pipe rank s holds only blocks s * per .. s * per + per - 1 (``per = depth
/ n_stages``), and the token batch flows through them in ``n_micro``
microbatches, each stage handing its output to the next by a
point-to-point send.  The schedule is GPipe's over ``n_micro + n_stages -
1`` ticks: at tick t stage s runs microbatch t - s when there is one, so
the JAX package's idle ticks, which compute a clamped repeat, are skipped
here.  The last stage's output is then broadcast to every stage (JAX: a
masked ``psum``), so each rank holds the whole output.

JAX gets the backward from the VJP of its ``lax.scan``; here it is one
``torch.autograd.Function`` over the whole pipeline (``_Pipeline``).  Its
forward runs the forward ticks and keeps each microbatch's graph of the
stage; its backward runs the ticks in reverse: the last stage takes its
own cotangent of the output (every rank computes the same loss on the
replicated output, so that cotangent counts once, not n_stages times), the
others receive theirs from the next stage, each backpropagates its saved
graph and sends the input's gradient to the previous stage.  Sends and
receives match in order on every stage, so nothing waits on a cycle.  The
input's gradient is broadcast from stage 0, so the prologue's gradients
(``mask_token``, the tokens) are whole on every stage.

``batch_axis`` composes it with data parallelism (a ('data', 'pipe')
mesh): each data rank runs the pipeline on its rows of every microbatch,
the rows are gathered after it (``_GatherRows``, whose backward keeps the
rank's own rows: the loss is the same on every rank) and the stage
gradients summed over the data axis.  ``tp_axis`` composes it with tensor
parallelism (a ('pipe', 'model') mesh): the stage's blocks are the
Megatron-sharded ones of parallel/tp.py (``shard_pp_params(...,
tp_axis=...)`` cuts the leaves by the same rule match), and every model
rank of a stage runs the same schedule, so the model axis's all-reduces
line up.

As in JAX it transforms the token refinement only and is not wired into
the train entry point: TransHE tiny fits a card many times over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import functional_call

from ..models.vit import TransHE, add_position
from .mesh import Axis, ProcessMesh, make_process_mesh
from .tp import match_tp_axes, shard_model_, shard_tensor


def make_pp_mesh(n_pipe: int) -> ProcessMesh:
    """The 1-D ('pipe',) mesh over every rank: rank s is stage s."""
    return make_process_mesh(("pipe",), (n_pipe,))


def stack_block_params(sd: dict, n_stages: int) -> dict:
    """A TransHE state dict ({blocks.i.*, mask_token, norm.*}) in the
    pipeline layout: {'stages': {leaf: (n_stages, per, ...)}, 'mask_token',
    'norm': {'weight', 'bias'}}, each block leaf stacked over depth then
    folded to (stage, block within the stage)."""
    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    if depth == 0 or depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by n_stages {n_stages}")
    per = depth // n_stages
    leaves = sorted(k[len("blocks.0."):] for k in sd
                    if k.startswith("blocks.0."))

    def stk(leaf):
        a = torch.stack([sd[f"blocks.{i}.{leaf}"] for i in range(depth)])
        return a.reshape((n_stages, per) + a.shape[1:])

    return {"stages": {leaf: stk(leaf) for leaf in leaves},
            "mask_token": sd["mask_token"],
            "norm": {"weight": sd["norm.weight"], "bias": sd["norm.bias"]}}


def unstack_block_params(pp_params: dict, first_stage: int = 0) -> dict:
    """Inverse of stack_block_params (also of one stage's shard, whose
    blocks are numbered from ``first_stage``): a TransHE state dict."""
    out = {}
    for leaf, a in pp_params["stages"].items():
        s, per = a.shape[:2]
        for i in range(s * per):
            out[f"blocks.{first_stage * per + i}.{leaf}"] = \
                a[i // per, i % per]
    out["mask_token"] = pp_params["mask_token"]
    out["norm.weight"] = pp_params["norm"]["weight"]
    out["norm.bias"] = pp_params["norm"]["bias"]
    return out


def shard_pp_params(mesh: ProcessMesh, pp_params: dict,
                    tp_axis: Optional[str] = None,
                    num_heads: Optional[int] = None) -> dict:
    """This rank's part of stacked params: its pipe stage's blocks (the
    leaves' (1, per, ...) slice), mask_token and norm whole (copies).
    With ``tp_axis`` each stage leaf is also cut Megatron-style over that
    axis (``tp.match_tp_axes`` on the dims past (stage, block); TransHE's
    ``num_heads`` decides the attention split), replicated where it does
    not divide, as ``tp_param_specs`` does."""
    pipe = mesh["pipe"]
    tp = None
    if tp_axis is not None:
        if num_heads is None:
            raise ValueError("shard_pp_params with tp_axis needs num_heads")
        tp = mesh[tp_axis]
    stages = {}
    for leaf, a in pp_params["stages"].items():
        if a.shape[0] % pipe.size:
            raise ValueError(
                f"params stacked for {a.shape[0]} stages do not split over "
                f"the pipe axis of {pipe.size}")
        n = a.shape[0] // pipe.size
        mine = a[pipe.rank * n:(pipe.rank + 1) * n]
        spec = (match_tp_axes(leaf, tuple(a.shape), tp.size, num_heads,
                              dim_offset=2) if tp is not None else None)
        if spec is not None:
            mine = shard_tensor(mine, spec, tp.rank, tp.size)
        stages[leaf] = mine.detach().clone()
    return {"stages": stages,
            "mask_token": pp_params["mask_token"].detach().clone(),
            "norm": {k: v.detach().clone()
                     for k, v in pp_params["norm"].items()}}


# ------------------------------------------------------- the transports
def _gloo_on_card(t, axis: Axis) -> bool:
    """A CUDA tensor over a gloo group goes through the host."""
    return t.is_cuda and dist.get_backend(axis.group) == dist.Backend.GLOO


def _send(t, dst: int, axis: Axis):
    t = t.detach().contiguous()
    dist.send(t.cpu() if _gloo_on_card(t, axis) else t, dst=dst,
              group=axis.group)


def _recv(like, src: int, axis: Axis):
    host = _gloo_on_card(like, axis)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    dist.recv(buf, src=src, group=axis.group)
    return buf.to(like.device)


def _broadcast(t, src: int, axis: Axis):
    """t from world rank src on every rank of the axis (bytes, so any
    dtype)."""
    host = _gloo_on_card(t, axis)
    buf = t.detach().contiguous()
    buf = buf.cpu() if host else buf.clone()
    flat = buf.view(torch.uint8) if buf.dtype.itemsize == 1 else buf.view(
        {2: torch.int16, 4: torch.int32, 8: torch.int64}[buf.dtype.itemsize])
    dist.broadcast(flat, src=src, group=axis.group)
    return buf.to(t.device)


def _all_gather_rows(t, axis: Axis):
    """Every rank's t, concatenated along dim 1 in rank order."""
    host = _gloo_on_card(t, axis)
    src = t.detach().contiguous()
    src = src.cpu() if host else src
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=1).to(t.device)


class _GatherRows(torch.autograd.Function):
    """The rows of every data rank, in rank order (dim 1); the gradient
    keeps this rank's rows (every rank's loss is the same one)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_gather_rows(x, axis)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return g.chunk(a.size, dim=1)[a.rank].contiguous(), None


class _SplitRows(torch.autograd.Function):
    """This data rank's rows (dim 1); the gradient gathered from every
    rank's rows, so the whole input's gradient is on each."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.chunk(axis.size, dim=1)[axis.rank].clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_rows(g, ctx.axis), None


# --------------------------------------------------------- the pipeline
@dataclass(frozen=True)
class _Plan:
    pipe: Axis
    data: Optional[Axis]
    block: torch.nn.Module  # one Block whose parameters each call replaces
    leaves: tuple
    n_micro: int
    out_dtype: torch.dtype
    dtype: torch.dtype


def _stage_forward(plan: _Plan, params, x):
    """This stage's blocks, in order, on x."""
    per = params[0].shape[1]
    for i in range(per):
        x = functional_call(plan.block, {k: p[0, i] for k, p in
                                         zip(plan.leaves, params)},
                            (x, plan.dtype))
    return x


class _Pipeline(torch.autograd.Function):
    """The stages over (n_micro, rows, C, D) microbatches, GPipe-scheduled
    forward and backward (see the module docstring); the output whole on
    every pipe rank."""

    @staticmethod
    def forward(ctx, plan: _Plan, xm, *params):
        pipe, s = plan.pipe, plan.pipe.rank
        n_st, n_mb = pipe.size, plan.n_micro
        like = xm[0].to(plan.out_dtype)
        leaves = [p.detach().requires_grad_() for p in params]
        saved = []
        out = torch.zeros(xm.shape, dtype=plan.out_dtype, device=xm.device)
        for t in range(n_mb + n_st - 1):
            j = t - s
            if not 0 <= j < n_mb:
                continue
            inp = xm[j] if s == 0 else _recv(like, pipe.ranks[s - 1], pipe)
            x_in = inp.detach().requires_grad_()
            with torch.enable_grad():
                y = _stage_forward(plan, leaves, x_in)
            saved.append((x_in, y))
            if s < n_st - 1:
                _send(y, pipe.ranks[s + 1], pipe)
            else:
                out[j] = y.detach()
        ctx.plan, ctx.saved, ctx.leaves = plan, saved, leaves
        ctx.x_shape, ctx.x_dtype = xm.shape, xm.dtype
        return _broadcast(out, pipe.ranks[-1], pipe)

    @staticmethod
    def backward(ctx, g_out):
        plan, leaves = ctx.plan, ctx.leaves
        pipe, s = plan.pipe, plan.pipe.rank
        n_st, n_mb = pipe.size, plan.n_micro
        grads = [torch.zeros_like(p) for p in leaves]
        gx = torch.zeros(ctx.x_shape, dtype=ctx.x_dtype,
                         device=g_out.device)
        for t in reversed(range(n_mb + n_st - 1)):
            j = t - s
            if not 0 <= j < n_mb:
                continue
            x_in, y = ctx.saved[j]
            g = (g_out[j] if s == n_st - 1
                 else _recv(y, pipe.ranks[s + 1], pipe))
            got = torch.autograd.grad(y, [x_in, *leaves], g,
                                      allow_unused=True)
            if s > 0:
                _send(got[0], pipe.ranks[s - 1], pipe)
            else:
                gx[j] = got[0]
            for acc, d in zip(grads, got[1:]):
                if d is not None:
                    acc += d
        ctx.saved = None
        if plan.data is not None:  # stage params are replicated over data
            for acc in grads:
                dist.all_reduce(acc, group=plan.data.group)
        gx = _broadcast(gx, pipe.ranks[0], pipe)
        return (None, gx, *grads)


def make_pp_vit_apply(model: TransHE, mesh: ProcessMesh, n_micro: int,
                      batch_axis: Optional[str] = None,
                      tp_axis: Optional[str] = None):
    """``apply(pp_params, tokens, pe, mask=None)``, equal to ``model(tokens,
    pe, mask)`` with the blocks pipelined over mesh axis 'pipe' and the
    token batch split into ``n_micro`` microbatches.  ``model`` gives the
    shape and the compute dtype (its weights are not read); pp_params is
    this rank's ``shard_pp_params`` (leaves that require grad get their
    gradients).  tokens (B, C, D), B % n_micro == 0; pe (B, C, 3)
    centroids or a (B, C, D) table, as TransHE takes them.

    batch_axis: a second mesh axis whose ranks each run the pipeline on
    their share of every microbatch's rows (DP x PP).  tp_axis: a mesh
    axis over which each stage's blocks are tensor-parallel (PP x TP;
    shard_pp_params with the same tp_axis)."""
    n_stages = mesh.shape["pipe"]
    if batch_axis is not None and batch_axis not in mesh.shape:
        raise ValueError(f"batch_axis {batch_axis!r} not in mesh {mesh.shape}")
    if tp_axis is not None:
        if tp_axis not in mesh.shape:
            raise ValueError(f"tp_axis {tp_axis!r} not in mesh {mesh.shape}")
        if tp_axis in ("pipe", batch_axis):
            raise ValueError(f"tp_axis {tp_axis!r} must be a distinct axis")
    if model.depth % n_stages:
        raise ValueError(
            f"depth {model.depth} not divisible by pipe axis {n_stages}")
    dim, dt = model.embed_dim, model.compute_dtype
    with torch.device("meta"):  # shapes only: each call supplies weights
        template = TransHE(dim, 1, model.num_heads, model.mlp_ratio, dt)
    if tp_axis is not None:
        shard_model_(template, mesh[tp_axis])
    block = template.blocks[0]
    data = mesh[batch_axis] if batch_axis is not None else None

    def apply(pp_params, tokens, pe, mask=None):
        b = tokens.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        leaves = tuple(sorted(pp_params["stages"]))
        params = [pp_params["stages"][k] for k in leaves]
        lead = params[0].shape[0]
        if lead != 1:
            # a stacking for more stages would otherwise run only the
            # first block set of each stage and silently drop the rest
            raise ValueError(
                f"params stacked for {lead * n_stages} stages but mesh "
                f"'pipe' axis is {n_stages}; restack with "
                f"stack_block_params(p, {n_stages})")
        x = add_position(tokens, pe, mask, pp_params["mask_token"], dim)
        xm = x.reshape((n_micro, b // n_micro) + x.shape[1:])
        if data is not None:
            if xm.shape[1] % data.size:
                raise ValueError(
                    f"microbatch rows {xm.shape[1]} not divisible by "
                    f"{batch_axis} axis {data.size}")
            xm = _SplitRows.apply(xm, data)
        plan = _Plan(mesh["pipe"], data, block, leaves, n_micro,
                     torch.promote_types(x.dtype, dt), dt)
        y = _Pipeline.apply(plan, xm, *params)
        if data is not None:
            y = _GatherRows.apply(y, data)
        y = y.reshape((b,) + y.shape[2:])
        norm = pp_params["norm"]
        return F.layer_norm(y.float(), (dim,), norm["weight"], norm["bias"],
                            1e-6).to(dt)

    return apply
