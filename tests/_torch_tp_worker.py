"""One rank of tests/test_torch_tp.py and tests/test_torch_pp.py: a gloo
process group over a ``file://`` rendezvous in the test's temporary
directory (as tests/_torch_parallel_worker.py), then one job.  Imports
neither JAX nor the JAX package.

    python tests/_torch_tp_worker.py JOB DIR RANK WORLD

JOB ``tp`` (WORLD 4, a 2 x 2 ('data', 'model') mesh) on DIR/input.pt's
weights and samples: one tensor-parallel step, steps at accum_steps 1 and
2 on samples with equal images, 3 uninterrupted steps with jitter on
against 2 steps, a save, a resume into a fresh mesh and a third step, a
resume from DIR/one.pth (a one-process file), and TransHE at 3 heads
(attention replicated) against itself unsharded; writes DIR/tp_<rank>.pt.  JOB ``pp`` (WORLD 2 or 4) on
DIR/pp_input.pt's TransHE weights and tokens: the pipelined TransHE's
cases for that world; writes DIR/pp<WORLD>_<rank>.pt.
"""

import os
import sys

import torch

from _torch_parallel_worker import THREADS, _pipe


def _gather_grads(net, sh):
    """The whole gradient of every parameter of a sharded net (zeros where
    none), over the model axis."""
    from transhuman_tpu_torch.parallel import tp

    out = {}
    for n, p in net.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[n] = tp._gather(g, sh.specs[n], sh.axis) if n in sh.specs \
            else g.detach().clone()
    return out


def _opt_state(state):
    """The gathered optimizer state dict of a TrainState."""
    from transhuman_tpu_torch.parallel import tp

    return tp.gather_optimizer_state(state)


def _local(state):
    """This rank's parameters and optimizer moments, as they are."""
    return ({n: p.detach().clone() for n, p in
             state.model.named_parameters()},
            {i: {k: v.clone() for k, v in st.items()} for i, st in
             state.optimizer.state_dict()["state"].items()})


def _equal(a, b) -> bool:
    """Two nests of dicts, tuples and tensors, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def tp_job(out_dir, rank, world):
    from transhuman_tpu_torch.models.vit import TransHE
    from transhuman_tpu_torch.parallel import barrier, make_tp_mesh, tp
    from transhuman_tpu_torch.render.pipeline import fold_in
    from transhuman_tpu_torch.train import checkpoint as ckpt_io
    from transhuman_tpu_torch.train import step as tstep

    inp = torch.load(os.path.join(out_dir, "input.pt"), weights_only=False)
    mesh = make_tp_mesh(2, 2)
    b = inp["b_local"]
    local = inp["samples"][mesh.data.rank * b:(mesh.data.rank + 1) * b]
    res = {"data_rank": mesh.data.rank, "model_rank": mesh.model.rank}

    def fresh(accum=1, perturb=False, ckpt=None, m=mesh):
        pipe = _pipe(inp)
        opt, sched = tstep.make_optimizer(pipe.model.parameters(),
                                          iters_per_epoch=4)
        state = tstep.TrainState(pipe.model, opt, sched)
        if ckpt is not None:
            ckpt_io.restore(state, ckpt_io.read_checkpoint(ckpt, 2))
        tp.shard_train_state_(state, m.model)
        step = tp.make_tp_train_step(pipe, m, perturb=perturb,
                                     accum_steps=accum)
        return pipe, state, step

    # (a) one step, jitter off
    pipe, state, step = fresh()
    stats = step(state, local, 7)
    sh = tp.sharding_of(state.model)
    res["step"] = {
        "stats": stats, "comm": step.comm,
        "grads": _gather_grads(state.model, sh),
        "local_grads": {n: p.grad.clone() for n, p in
                        state.model.named_parameters()
                        if p.grad is not None},
        "params": tp.gather_state_dict(state.model),
        "shapes": {n: tuple(p.shape) for n, p in
                   state.model.named_parameters()},
        "moment_shapes": {
            n: tuple(state.optimizer.state[p]["exp_avg"].shape)
            for n, p in state.model.named_parameters()
            if p in state.optimizer.state},
        "bytes": tp.vit_bytes(state),
        "sharded": sorted(sh.specs)}

    # (b) accum_steps 1 and 2 on samples with the same input images
    same = inp["same_images"][mesh.data.rank * b:(mesh.data.rank + 1) * b]
    res["accum"] = []
    for accum in (1, 2):
        _, state, step = fresh(accum=accum)
        stats = step(state, same, 7)
        res["accum"].append({"loss": stats["loss"],
                             "params": tp.gather_state_dict(state.model)})

    # (c) 3 steps with jitter on, uninterrupted; 2, a save, a resume
    pipe, state, step = fresh(perturb=True)
    seeds, render = [], pipe.render_train_batch

    def spy(frames, rays, batch_seeds, *args, **kwargs):
        seeds.extend(batch_seeds)
        return render(frames, rays, batch_seeds, *args, **kwargs)

    pipe.render_train_batch = spy
    for it in range(3):
        step(state, local, fold_in(7, it))
    res["seeds"] = seeds[:b]
    full = (tp.gather_state_dict(state.model), _opt_state(state))
    _, state, step = fresh(perturb=True)
    for it in range(2):
        step(state, local, fold_in(7, it))
    saved = _local(state)
    two = (tp.gather_state_dict(state.model), _opt_state(state))
    res["two"] = two if rank == 0 else None
    path = os.path.join(out_dir, "tp.pth")
    ckpt_io.save_checkpoint(path, state, 0, write=rank == 0)
    barrier(mesh.world)
    mesh2 = make_tp_mesh(2, 2)  # a fresh mesh, the same layout
    _, state, step = fresh(perturb=True, ckpt=path, m=mesh2)
    res["resumed_equal"] = _equal(saved, _local(state))
    res["resumed_step"] = state.step
    step(state, local, fold_in(7, 2))
    res["third_equal"] = _equal(full, (tp.gather_state_dict(state.model),
                                       _opt_state(state)))

    # (d) a one-process file resumes under TP
    one = ckpt_io.read_checkpoint(os.path.join(out_dir, "one.pth"), 2)
    _, state, step = fresh(ckpt=os.path.join(out_dir, "one.pth"))
    specs = tp.sharding_of(state.model).specs
    want = tp.shard_state_dict(one["net"], specs, mesh.model)
    got = {n: p.detach() for n, p in state.model.named_parameters()}
    res["one_resumed_equal"] = all(torch.equal(got[n], want[n]) for n in got)
    names = tp._param_names(state)
    moments = {names[i]: st["exp_avg"] for i, st in
               state.optimizer.state_dict()["state"].items()}
    want_m = tp.shard_state_dict(
        {names[i]: st["exp_avg"] for i, st in one["optim"]["state"].items()},
        specs, mesh.model)
    res["one_moments_equal"] = moments.keys() == want_m.keys() and all(
        torch.equal(moments[n], want_m[n]) for n in moments)
    res["one_step"] = state.step
    stats = step(state, local, 7)
    res["one_next_loss"] = stats["loss"]

    # (e) TransHE at 3 heads over the model axis: attention replicated,
    # the MLP sharded, the numbers those of the whole module
    torch.manual_seed(3)
    whole = TransHE(embed_dim=12, depth=2, num_heads=3)
    with torch.no_grad():
        for p in whole.parameters():
            p.normal_(0, 0.3)
    part = TransHE(embed_dim=12, depth=2, num_heads=3)
    part.load_state_dict(whole.state_dict())
    tp.shard_model_(part, mesh.model)
    g = torch.Generator().manual_seed(4)
    tok = torch.randn(3, 5, 12, generator=g)
    pe = torch.rand(3, 5, 3, generator=g) * 2 - 1
    mesh.model.log.reset()
    y_part = part(tok, pe)
    (y_part ** 2).mean().backward()
    count = mesh.model.log.count
    y_whole = whole(tok, pe)
    (y_whole ** 2).mean().backward()
    gw = dict(whole.named_parameters())
    specs = tp.sharding_of(part).specs
    blk = part.blocks[0]
    grad_err = 0.0
    for n, p in part.named_parameters():
        if p.grad is None:  # mask_token: no mask, no gradient
            assert gw[n].grad is None, n
            continue
        g = tp._gather(p.grad, specs[n], mesh.model) if n in specs \
            else p.grad
        grad_err = max(grad_err, float((g - gw[n].grad).abs().max()))
    res["fallback"] = {
        "sharded": sorted(specs),
        "kinds": [type(m).__name__ for m in (blk.attn.qkv, blk.attn.proj,
                                             blk.mlp.fc1, blk.mlp.fc2)],
        "count": count,
        "out_err": float((y_part - y_whole).abs().max()),
        "grad_err": grad_err}
    torch.save(res, os.path.join(out_dir, f"tp_{rank}.pt"))


def _pp_net(inp, dtype=torch.float32, depth=None):
    from transhuman_tpu_torch.models.vit import TransHE

    net = TransHE(inp["dim"], depth or inp["depth"], inp["heads"],
                  compute_dtype=dtype)
    if depth is None:
        net.load_state_dict(inp["sd"])
    return net


def _grad_case(inp, mesh, n_micro, tgt, batch_axis=None, tp_axis=None):
    """(output, the whole TransHE gradient state dict of this rank's
    stage: its blocks, mask_token, norm) of the pipelined loss."""
    from transhuman_tpu_torch.parallel import pp, tp

    net = _pp_net(inp)
    apply = pp.make_pp_vit_apply(net, mesh, n_micro, batch_axis=batch_axis,
                                 tp_axis=tp_axis)
    params = pp.shard_pp_params(mesh, pp.stack_block_params(
        inp["sd"], mesh.shape["pipe"]), tp_axis=tp_axis,
        num_heads=inp["heads"])
    leaves = ([*params["stages"].values(), params["mask_token"],
               *params["norm"].values()])
    for t in leaves:
        t.requires_grad_()
    y = apply(params, inp["tokens"], inp["pe"])
    ((y - tgt) ** 2).mean().backward()
    grads = {"stages": {}, "mask_token": params["mask_token"].grad,
             "norm": {k: v.grad for k, v in params["norm"].items()}}
    for leaf, t in params["stages"].items():
        g = t.grad
        if tp_axis is not None:
            spec = tp.match_tp_axes(leaf, (1, 1) + tuple(
                inp["sd"]["blocks.0." + leaf].shape), mesh[tp_axis].size,
                inp["heads"], dim_offset=2)
            if spec is not None:
                g = tp._gather(g, spec, mesh[tp_axis])
        grads["stages"][leaf] = g
    return y.detach(), pp.unstack_block_params(grads,
                                               mesh["pipe"].rank), params


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def pp_job(out_dir, rank, world):
    from transhuman_tpu_torch.parallel import make_process_mesh, pp

    inp = torch.load(os.path.join(out_dir, "pp_input.pt"),
                     weights_only=False)
    res = {}
    net = _pp_net(inp)
    tok, pe = inp["tokens"], inp["pe"]

    def forward(mesh, n_micro, net=net, tokens=tok, pe=pe, mask=None):
        apply = pp.make_pp_vit_apply(net, mesh, n_micro)
        params = pp.shard_pp_params(mesh, pp.stack_block_params(
            net.state_dict(), mesh.shape["pipe"]))
        with torch.no_grad():
            return apply(params, tokens, pe, mask)

    if world == 2:
        mesh = pp.make_pp_mesh(2)
        for n_micro in (2, 4):
            res[f"fwd_2_{n_micro}"] = forward(mesh, n_micro)
        res["mask_table"] = forward(mesh, 2, pe=inp["table"],
                                    mask=inp["mask"])
        res["grads"] = _grad_case(inp, mesh, 2, inp["tgt"])[:2]
        net16 = _pp_net(inp, torch.bfloat16)
        net16.load_state_dict(inp["sd"])
        res["bf16"] = forward(mesh, 2, net=net16)
        params = pp.shard_pp_params(mesh, pp.stack_block_params(
            inp["sd"], 2))
        res["stage_params"] = {k: v.clone() for k, v in
                               params["stages"].items()}
        apply3 = pp.make_pp_vit_apply(net, mesh, 3)
        apply2 = pp.make_pp_vit_apply(net, mesh, 2)
        pp4 = pp.shard_pp_params(mesh, pp.stack_block_params(inp["sd"], 4))
        res["errors"] = {
            "stack": _error(lambda: pp.stack_block_params(inp["sd"], 3)),
            "depth": _error(lambda: pp.make_pp_vit_apply(
                _pp_net(inp, depth=3), mesh, 2)),
            "micro": _error(lambda: apply3(params, tok, pe)),
            "stacked": _error(lambda: apply2(pp4, tok, pe)),
            "tp_missing": _error(lambda: pp.make_pp_vit_apply(
                net, mesh, 2, tp_axis="nope")),
            "tp_pipe": _error(lambda: pp.make_pp_vit_apply(
                net, mesh, 2, tp_axis="pipe"))}
    else:
        mesh = pp.make_pp_mesh(4)
        for n_micro in (4, 1):
            res[f"fwd_4_{n_micro}"] = forward(mesh, n_micro)
        dp = make_process_mesh(("data", "pipe"), (2, 2))
        res["dp"] = _grad_case(inp, dp, 2, inp["tgt_dp"],
                               batch_axis="data")[:2]
        mp = make_process_mesh(("pipe", "model"), (2, 2))
        y, g, params = _grad_case(inp, mp, 2, inp["tgt_tp"],
                                  tp_axis="model")
        res["tp"] = (y, g)
        res["tp_shapes"] = {k: tuple(v.shape) for k, v in
                            params["stages"].items()}
    torch.save(res, os.path.join(out_dir, f"pp{world}_{rank}.pt"))


def main():
    job, out_dir, rank, world = sys.argv[1], sys.argv[2], *map(
        int, sys.argv[3:5])
    torch.set_num_threads(THREADS)
    from transhuman_tpu_torch.parallel import init_distributed, shutdown

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    init_distributed("gloo", "file://" + os.path.join(out_dir,
                                                      f"rdzv_{job}{world}"))
    try:
        {"tp": tp_job, "pp": pp_job}[job](out_dir, rank, world)
    finally:
        shutdown()



# ------------------------------------------- the test side: spawn, join
RANK_TIMEOUT = 300  # s per rank; a hung collective fails the test


def spawn(job, out_dir, world):
    """Start the ranks of job together (the caller joins them)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "XLA_FLAGS")}
    env.update(PYTHONPATH=root, OMP_NUM_THREADS=str(THREADS))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(out_dir),
         str(r), str(world)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def join(procs):
    """Wait for each rank within RANK_TIMEOUT; raise with the output of any
    rank that failed or timed out."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {len(procs)} failed:\n{out}"
    return outs


if __name__ == "__main__":
    main()
