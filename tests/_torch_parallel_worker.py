"""One rank of tests/test_torch_parallel.py: a gloo process group over a
``file://`` rendezvous in the test's temporary directory (no port, so
parallel test workers never race for one), then one job of the port.
Imports neither JAX nor the JAX package.

    python tests/_torch_parallel_worker.py JOB DIR RANK WORLD

JOB ``step``: the train step over the ranks on DIR/input.pt's weights and
samples (rank r takes its B of them), then rank 0 alone runs the encoder
and a decode outside any step, which must run no collective; each rank
writes DIR/step_<rank>.pt.  JOB ``train``: the train entry point, then
its ``--test`` pass.  JOB ``run``: the run entry point with the argv of
DIR/argv.json, on the synthetic scene with the input images of frame i
scaled by 1 - 0.1 i, so that frames differ (WORLD 1: one process, no
group).
"""

import json
import os
import sys

import torch

THREADS = 2


def _pipe(inp):
    from transhuman_tpu_torch import weights
    from transhuman_tpu_torch.geometry.clusters import ClusterSpec
    from transhuman_tpu_torch.geometry.smpl import SMPLModel
    from transhuman_tpu_torch.models.network import TransHumanNet
    from transhuman_tpu_torch.render.pipeline import RenderPipeline

    c = inp["shape"]
    net = TransHumanNet(embed_dim=c["embed"], vit_depth=c["depth"],
                        vit_heads=c["heads"], knn_k=c["k"])
    weights.load_reference_state_dict(net, inp["sd"])
    return RenderPipeline(
        net.eval(), ClusterSpec(inp["vert2cluster"], c["n_clusters"]),
        SMPLModel.synthetic(n_verts=c["n_verts"]).v_template,
        n_samples=c["n_samples"], train_cull=inp["train_cull"],
        remat=inp.get("remat", False), device="cpu")


def step_job(out_dir, mesh):
    from transhuman_tpu_torch.models.layers import BatchStatNorm
    from transhuman_tpu_torch.render.volume import sample_along_rays
    from transhuman_tpu_torch.train import step as tstep

    inp = torch.load(os.path.join(out_dir, "input.pt"), weights_only=False)
    pipe = _pipe(inp)
    b, accum = inp["b_local"], inp["accum"]
    local = inp["samples"][mesh.rank * b:(mesh.rank + 1) * b]
    opt, sched = tstep.make_optimizer(pipe.model.parameters(),
                                      iters_per_epoch=4)
    state = tstep.TrainState(pipe.model, opt, sched)
    step = tstep.make_train_step(pipe, perturb=False, accum_steps=accum,
                                 mesh=mesh)
    seeds = []
    render = pipe.render_train_batch

    def spy(frames, rays, batch_seeds, *args, **kwargs):
        seeds.extend(batch_seeds)
        return render(frames, rays, batch_seeds, *args, **kwargs)

    pipe.render_train_batch = spy
    stats = step(state, local, 7)
    grads = {n: p.grad.clone() for n, p in pipe.model.named_parameters()}
    norms = [m.group for m in pipe.model.modules()
             if isinstance(m, BatchStatNorm)]
    local_eval = None
    if mesh.rank == 0:
        # outside a step no collective runs in the model: rank 0 alone
        # encodes and decodes (a collective here would wait for rank 1,
        # which goes straight to the barrier, and time the test out)
        frame, rays = local[0].frame, local[0].rays
        with torch.no_grad():
            pro = pipe.prologue(frame)
            pts, _ = sample_along_rays(rays.ray_o, rays.ray_d, rays.near,
                                       rays.far, pipe.n_samples)
            pts = pts.reshape(-1, 3)[:64]
            raw = pipe.query_points(frame, pro, pts,
                                    torch.zeros(pts.shape[0], 27))
        local_eval = {"tokens": pro.tokens, "raw": raw}
    from transhuman_tpu_torch.parallel import barrier

    barrier(mesh)
    torch.save({"stats": stats, "grads": grads,
                "params": {k: v.clone() for k, v in
                           pipe.model.state_dict().items()},
                "norm_groups": [g is None for g in norms],
                "comm": step.comm, "local": pipe.last_frame_stats,
                "eval": local_eval, "seeds": seeds},
               os.path.join(out_dir, f"step_{mesh.rank}.pt"))


class VaryingFrames:
    """The synthetic test data, frame i's input views scaled by 1 - 0.1 i
    in its eval, perform and mesh items (the synthetic scene repeats one
    frame)."""

    def __init__(self, data):
        self.data = data
        self.smpl = data.smpl

    def __getattr__(self, name):
        return getattr(self.data, name)

    def get_eval_item(self, index):
        item = self.data.get_eval_item(index)
        item.frame.images = item.frame.images * (1.0 - 0.1 * index)
        return item

    def get_perform_item(self, index, **kwargs):
        item = self.data.get_perform_item(index, **kwargs)
        item.frame.images = item.frame.images * (1.0 - 0.1 * index)
        return item

    def get_mesh_item(self, index):
        frame, bounds, meta = self.data.get_mesh_item(index)
        frame.images = frame.images * (1.0 - 0.1 * index)
        return frame, bounds, meta


def run_job(out_dir, mesh):
    """The run entry point with DIR/argv.json's argv on VaryingFrames;
    writes its result (the summary, or the paths it wrote) and the write
    flags its evaluator's summarize got to DIR/run_<rank>.json."""
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.cli.common import make_dataset, parse_args
    from transhuman_tpu_torch.evals.evaluator import Evaluator

    with open(os.path.join(out_dir, "argv.json")) as f:
        argv = json.load(f)
    _, cfg = parse_args(argv, need_type=True)
    writes, summarize = [], Evaluator.summarize

    def spy(self, write=True):
        writes.append(write)
        return summarize(self, write)

    Evaluator.summarize = spy
    out = run_cli.main(argv, dataset=VaryingFrames(make_dataset(cfg, "test")))
    with open(os.path.join(out_dir, f"run_{mesh.rank}.json"), "w") as f:
        json.dump({"out": out, "writes": writes}, f)


class Taken:
    """The synthetic train data, noting which samples this rank takes."""

    def __init__(self, data):
        self.data = data
        self.smpl = data.smpl
        self.taken = []

    def __len__(self):
        return len(self.data)

    def __getattr__(self, name):
        return getattr(self.data, name)

    def get_train_sample(self, index):
        self.taken.append(int(index))
        return self.data.get_train_sample(index)


def train_job(out_dir, mesh):
    """The train entry point with DIR/argv.json's argv, then its --test
    pass with DIR/test_argv.json's; writes DIR/train_<rank>.json."""
    from transhuman_tpu_torch.cli import train as train_cli
    from transhuman_tpu_torch.cli.common import make_dataset

    with open(os.path.join(out_dir, "argv.json")) as f:
        argv = json.load(f)
    with open(os.path.join(out_dir, "test_argv.json")) as f:
        test_argv = json.load(f)
    data = Taken(make_dataset(train_cli.parse_args(argv)[1], "train"))
    _, records = train_cli.main(argv, dataset=data)
    val_stats, summary = train_cli.main(test_argv)
    with open(os.path.join(out_dir, f"train_{mesh.rank}.json"), "w") as f:
        json.dump({"taken": data.taken, "records": records,
                   "val": val_stats, "summary": summary}, f)


def main():
    job, out_dir, rank, world = sys.argv[1], sys.argv[2], *map(
        int, sys.argv[3:5])
    torch.set_num_threads(THREADS)
    from transhuman_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown,
    )

    if world > 1:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
        init_distributed("gloo", "file://" + os.path.join(out_dir, "rdzv"))
    mesh = make_mesh()
    try:
        {"step": step_job, "run": run_job,
         "train": train_job}[job](out_dir, mesh)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
