"""Pipeline-parallel vit_base TransHE in the PyTorch port: the user path
for parallel/pp.py (the counterpart of examples/pp_vit_base.py).

The reference ships vit_small/vit_base TransHE factories
(vision_transformer.py:404-417) but no way to run them beyond one GPU.
This example pipelines a real vit_base TransHE (768-d, 12 blocks, 12
heads, ~85 MB of block parameters in float32) over torchrun ranks -- each
rank holds only its stage's blocks -- and checks the pipelined forward
(within 1e-5) and gradients (within 2e-6) against the unsharded module on
the same seeded weights.  ``--tp M`` makes each stage tensor-parallel over
M ranks (PP x TP, a ('pipe', 'model') mesh of stages x M ranks).

On the cards (one rank a card over NCCL; ``--dist_backend gloo`` lets
ranks share a card):

    torchrun --standalone --nproc_per_node 4 examples/torch_pp_vit_base.py

On the CPU over gloo:

    torchrun --standalone --nproc_per_node 4 examples/torch_pp_vit_base.py \\
        --device cpu
    torchrun --standalone --nproc_per_node 8 examples/torch_pp_vit_base.py \\
        --device cpu --tp 2

The stored positional table is random in [-1, 1]: at embed_dim 768 the
centroids' encoding has a top band of pi * 2^127, which overflows float32
to NaN in this formulation and the reference's, so a vit_base run must
carry a stored table (models/vit.py).
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from transhuman_tpu_torch.cli.common import configure_device  # noqa: E402
from transhuman_tpu_torch.models.vit import TransHE  # noqa: E402
from transhuman_tpu_torch.parallel import (  # noqa: E402
    init_distributed,
    make_pp_mesh,
    make_process_mesh,
    pp,
    shutdown,
    tp,
)

FWD_ATOL, GRAD_ATOL = 1e-5, 2e-6


def seeded_base(depth: int, batch: int, tokens: int, device):
    """TransHE base (768, 12 heads) of depth blocks with seeded weights
    (every matrix N(0, 1/fan_in), norms 1, biases N(0, 0.02^2)), its
    tokens, a stored (B, C, 768) table in [-1, 1] and a target."""
    g = torch.Generator().manual_seed(0)
    net = TransHE(768, depth, 12)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) / p.shape[-1]**0.5)
            elif "norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    shape = (batch, tokens, 768)
    x = [torch.randn(shape, generator=g), torch.rand(shape, generator=g) * 2
         - 1, torch.randn(shape, generator=g)]
    return net.to(device), *(t.to(device) for t in x)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--stages", type=int, default=0,
                   help="pipe axis size (0: every rank, over --tp)")
    p.add_argument("--micro", type=int, default=4, help="microbatches")
    p.add_argument("--tp", type=int, default=1,
                   help=">1: Megatron TP within each stage over a second "
                        "'model' axis (stages x tp ranks)")
    p.add_argument("--batch", type=int, default=8, help="ViT batch rows")
    p.add_argument("--tokens", type=int, default=300,
                   help="cluster tokens (num_class)")
    p.add_argument("--depth", type=int, default=12,
                   help="TransHE blocks (vit_base: 12)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist_backend", default="nccl",
                   help="on cards: nccl (one rank a card) or gloo")
    args = p.parse_args(argv)
    device = configure_device(args.device, args.dist_backend)
    init_distributed("gloo" if device.type == "cpu" else args.dist_backend)
    try:
        return run(args, device)
    finally:
        shutdown()


def run(args, device):
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    stages = args.stages or world // args.tp
    if args.tp > 1:
        mesh = make_process_mesh(("pipe", "model"), (stages, args.tp))
        tp_axis = "model"
    else:
        mesh, tp_axis = make_pp_mesh(stages), None
    net, tok, pe, tgt = seeded_base(args.depth, args.batch, args.tokens,
                                    device)
    rank = torch.distributed.get_rank() if world > 1 else 0
    lead = rank == 0
    n_bytes = sum(p.numel() * p.element_size() for p in net.parameters())
    if lead:
        print(f"vit_base TransHE: {n_bytes / 1e6:.1f} MB of params, depth "
              f"{args.depth}, {stages} pipeline stages"
              + (f" x TP {args.tp}" if args.tp > 1 else "") + f" [{device}]")
    apply = pp.make_pp_vit_apply(net, mesh, args.micro, tp_axis=tp_axis)
    sd = net.state_dict()
    params = pp.shard_pp_params(mesh, pp.stack_block_params(sd, stages),
                                tp_axis=tp_axis, num_heads=12)
    leaves = [*params["stages"].values(), params["mask_token"],
              *params["norm"].values()]
    for t in leaves:
        t.requires_grad_()
    qkv = params["stages"]["attn.qkv.weight"]
    whole = sd["blocks.0.attn.qkv.weight"].numel() * 4 * args.depth
    print(f"rank {rank}: attn.qkv.weight {tuple(qkv.shape)} on this rank, "
          f"{qkv.numel() * 4 / 1e6:.2f} MB of {whole / 1e6:.1f} MB",
          flush=True)

    ref_y = net(tok, pe)
    ((ref_y - tgt) ** 2).mean().backward()
    ref_g = {k: v.grad for k, v in net.named_parameters()}
    y = apply(params, tok, pe)
    err = float((y.detach() - ref_y.detach()).abs().max())
    ((y - tgt) ** 2).mean().backward()
    grads = {"stages": {}, "mask_token": params["mask_token"].grad,
             "norm": {k: v.grad for k, v in params["norm"].items()}}
    for leaf, t in params["stages"].items():
        g = t.grad
        spec = (tp.match_tp_axes(leaf, (1, 1) + tuple(
            sd["blocks.0." + leaf].shape), args.tp, 12, dim_offset=2)
            if tp_axis else None)
        if spec is not None:
            g = tp._gather(g, spec, mesh[tp_axis]).to(g.device)
        grads["stages"][leaf] = g
    mine = pp.unstack_block_params(grads, mesh["pipe"].rank)
    gerr = max(float((g - ref_g[k]).abs().max()) for k, g in mine.items()
               if g is not None)
    print(f"rank {rank}: pipelined forward max|delta| vs unsharded: "
          f"{err:.2e}; backward max|grad delta| over {len(mine)} leaves: "
          f"{gerr:.2e}", flush=True)
    if not (err <= FWD_ATOL and gerr <= GRAD_ATOL):
        raise SystemExit(f"rank {rank}: forward {err:.3g} (bound {FWD_ATOL})"
                         f" or gradient {gerr:.3g} (bound {GRAD_ATOL}) off")
    print(f"OK rank {rank}: pipelined vit_base forward+backward match the "
          "unsharded module", flush=True)
    return err, gerr


if __name__ == "__main__":
    main()
