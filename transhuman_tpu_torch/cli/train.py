"""Training entry point (counterpart of transhuman_tpu/cli/train.py):

    python -m transhuman_tpu_torch.cli.train [--cfg_file configs/train_or_eval.yaml]
        [--device cuda|cpu] [--test] [--weights PATH] [--steps N]
        [--out PATH] [key value ...]

The JAX CLI's lifecycle, in its order: a resume checkpoint is read first
(``resume``: the latest in ``trained_model_dir/task/exp_name``, the port's
``.pth`` or else the JAX package's ``.ckpt``; or ``specified_resume``, whose
absence is an error), so that a stored TransHE table rides along; LPIPS
(``lpips_weights``, ``lpips_backbone``) joins the loss, or the JAX warning
prints; a fresh run starts from ``testing.init_weights`` seeded with
``cfg.seed``, the encoder from ``encoder_weights`` when ``pretrained``;
then epochs of ``ep_iter`` steps, each of ``train.batch_size`` samples
taken in turn from a seeded permutation that cycles (the JAX CLI's order),
the batches prefetched on ``train.num_workers + 1`` threads, the batch's
``train.accum_steps`` microbatches in one step, a console line every
``log_interval`` steps and metrics every ``record_interval`` (the
Recorder, ``use_record``), and at each epoch's end ``latest.pth``, plus
``{epoch}.pth`` every ``save_freq`` epochs.  ``--test`` runs the
validation pass instead (weights-only load of ``test.epoch``'s checkpoint,
per-frame loss and the evaluator with LPIPS, one ``val`` record).

The data is the ZJU-MoCap layout under ``data_root`` (``dataset zju``,
data/zju.py) or the seeded synthetic scene at the render size
(``dataset synthetic``).  Each step's record holds ``sample_s``, the host
seconds its samples took in a loader thread, and ``data_s``, how long the
step waited for them (the queue and the copy to the device); with
``train.cull`` the console line and the record also show
``cull_survivors``, the fraction of the batch's points the step decoded.
``--steps N`` caps the run at N updates; ``--out PATH`` also receives the
final state.  It runs on the card (``--device cuda``, the default; without
a card that is an error) with the float32 math in full precision (TF32
off), or on the CPU with ``--device cpu``; ``compute_dtype bfloat16``
trains the bf16 network (float32 parameters, gradients, optimizer and
LPIPS).  With ``profile_dir DIR`` steps 5-8 of the first epoch (fewer in a
short epoch) run under torch.profiler; its chrome trace and a device-time
summary (``train/profile.py``) go to DIR.

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
transhuman_tpu_torch.cli.train [--dist_backend nccl|gloo] ...``) the run
is data-parallel, as the JAX CLI over its 'data' mesh: each step takes
``N x train.batch_size`` samples of the permutation, rank r the r-th
``train.batch_size`` of them; BatchNorm pools over the ranks and the
gradients are averaged once a step (train/step.py).  ``mesh_axis_data``
must be 0 or N.  Rank 0 alone records, saves (the others wait at a
barrier) and profiles; every rank resumes from the same file and prints
one ``rank report`` line at the end (its step ms, losses, the gradient
all-reduce's ms and MB a step, its kernel launches).  ``--test`` then
validates with the frames split over the ranks.  ``--test`` splits each
frame's rays over ``mesh_axis_rays`` devices (cli/run.py::FrameRenderer,
parallel/infer.py), in one process cards 0..R-1 and under torchrun local
rank l cards l*R..l*R+R-1 (R entries of ``cpu`` on the CPU); training
never reads the key, as in the JAX package, so a run trains alike at
every ``mesh_axis_rays``.

With ``mesh_axis_model`` M > 1 under torchrun the run is tensor-parallel
too, as the JAX CLI over its ('data', 'model') mesh: world rank r is data
index r // M and model index r % M (parallel/mesh.py::make_tp_mesh), the
world size must be a multiple of M and ``mesh_axis_data`` 0 or world / M.
After init or resume each rank keeps only its shard of TransHE's
Megatron-split weights and their Adam moments (parallel/tp.py); a step
takes ``world / M x train.batch_size`` samples, data index d the d-th
``train.batch_size`` of them (every model rank of it the same ones).
World rank 0 records; the model ranks of data index 0 gather the whole
state at each save and world rank 0 writes it, so the files are a single
process's, and a run resumes from either kind.  The rank report adds the
rank's TransHE parameter and moment bytes, the digests of its shards and
of its replicated parameters, and the model axis's all-reduce count and
ms a step.  ``--test`` runs on the
saved (whole) weights with the frames split over every rank, each
frame's rays over the rank's ``mesh_axis_rays`` devices.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..config import Config
from ..data.loader import Loader
from ..models.lpips import lpips_module
from ..parallel import tp
from ..parallel.mesh import (
    DataMesh,
    TPMesh,
    barrier,
    make_mesh,
    make_tp_train_mesh,
    shutdown,
)
from ..registry import EVALUATORS, TRAINERS
from ..render.pipeline import fold_in
from ..testing import init_weights
from ..train import checkpoint as ckpt_io
from ..train.profile import format_summary, load_trace, summarize_trace
from ..train.step import TrainState, make_optimizer
from ..utils.recorder import Recorder
from .common import (
    build_runtime,
    configure_device,
    make_dataset,
    maybe_init_distributed,
    model_dir,
    rank_report,
    seed_everything,
)
from .common import parse_args as _parse_args


def _train_flags(p):
    p.add_argument("--steps", type=int, default=0,
                   help="cap on the updates (0: train.epoch x ep_iter)")
    p.add_argument("--out", default=None,
                   help="also write the final state to this path")


def parse_args(argv=None):
    return _parse_args(argv, allow_test=True, extra=_train_flags,
                       prog="python -m transhuman_tpu_torch.cli.train")


def read_resume(cfg: Config):
    """The checkpoint a run resumes from (read_checkpoint's dict), or
    None: ``specified_resume`` (missing: FileNotFoundError), else with
    ``resume`` the latest in model_dir."""
    if cfg.specified_resume:
        if not os.path.isfile(cfg.specified_resume):
            # a silent fall-through would train from scratch and then
            # overwrite the existing checkpoints with random-init weights
            raise FileNotFoundError(
                f"specified_resume={cfg.specified_resume!r} does not exist")
        path = cfg.specified_resume
    elif cfg.resume:
        path = ckpt_io.find_checkpoint(model_dir(cfg))
    else:
        path = None
    if path is None:
        return None
    ckpt = ckpt_io.read_checkpoint(path, cfg.vit_depth)
    ckpt["path"] = path
    return ckpt


def build_trainer(cfg: Config, device, dataset=None, ckpt=None,
                  mesh=None):
    """(state, step_fn, dataset, pipe) for cfg on device: the model fresh
    (seeded init, the pretrained encoder when asked) or restored from ckpt
    (a read_checkpoint dict), with LPIPS in the loss when lpips_weights is
    set; the step data-parallel over mesh when it is distributed, and
    tensor-parallel when it is a TPMesh (the whole state sharded after
    the init or the restore)."""
    if dataset is None:
        dataset = make_dataset(cfg, "train")
    pe_table = ckpt["pe_table"] if ckpt else None
    model, pipe, _, _ = build_runtime(cfg, device, smpl=dataset.smpl,
                                      pe_table=pe_table)
    lpips = lpips_module(cfg, device)
    if lpips is None:
        print("WARNING: cfg.lpips_weights empty -> perceptual loss DISABLED; "
              "the trained model will NOT match the reference loss landscape "
              "(if_nerf_clight.py:65-72 adds 0.1*LPIPS).", file=sys.stderr)
    sch = cfg.train.scheduler
    opt, scheduler = make_optimizer(
        model.parameters(), lr=cfg.train.lr, end_lr=sch.end_lr,
        warmup_epochs=sch.warmup_epochs, decay_epochs=sch.decay_epochs,
        iters_per_epoch=cfg.ep_iter, weight_decay=cfg.train.weight_decay,
        optim=cfg.train.optim)
    state = TrainState(model, opt, scheduler)
    if ckpt is not None:
        ckpt_io.restore(state, ckpt)
    else:
        init_weights(model, torch.Generator().manual_seed(cfg.seed))
        if cfg.pretrained and cfg.encoder_weights:
            # ImageNet ResNet-18 (reference encoder.py:77-79), converted by
            # tools/convert_resnet.py
            from ..tools.convert_resnet import apply_pretrained

            with np.load(cfg.encoder_weights) as z:
                apply_pretrained(model, dict(z))
            print(f"loaded pretrained encoder weights: {cfg.encoder_weights}",
                  flush=True)
    step_kw = dict(l2_weight=cfg.l2rec_weight, perturb=cfg.perturb > 0,
                   accum_steps=cfg.train.accum_steps, lpips_fn=lpips,
                   lpips_weight=cfg.lpips_weight,
                   patch_mode=cfg.patch.use_patch_sampling)
    if isinstance(mesh, TPMesh):
        tp.shard_train_state_(state, mesh.model)
        step_fn = tp.make_tp_train_step(pipe, mesh, **step_kw)
    else:
        step_fn = TRAINERS.get(cfg.trainer)(pipe, mesh=mesh, **step_kw)
    return state, step_fn, dataset, pipe


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _write_profile(out_dir: str, prof, records):
    """The window's chrome trace and its device-time summary
    (train/profile.py) into out_dir; the summary is printed too."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_trace.json.gz")
    prof.export_chrome_trace(path)
    summary = summarize_trace(load_trace(path),
                              sum(r["step_s"] for r in records) * 1e3,
                              len(records))
    summary["first_step"] = records[0]["step"]
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"profiler trace (steps {records[0]['step']}-"
          f"{records[-1]['step']}) written to {path}\n"
          f"{format_summary(summary)}", flush=True)


def _timed_batch(dataset, indices):
    """(the train samples of indices, the host seconds they took)."""
    t0 = time.perf_counter()
    batch = [dataset.get_train_sample(int(i)) for i in indices]
    return batch, time.perf_counter() - t0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def validate(cfg: Config, device, dataset=None, weights=None, mesh=None):
    """The ``--test`` pass (JAX cli/train.py::validate): weights-only load
    of test.epoch's checkpoint (or ``weights``), run_mode test and perturb
    0, every val frame rendered with its img_loss (the in-box MSE), the
    evaluator with LPIPS, and one unconditional 'val' record (rank 0's).
    Over a distributed mesh the frames are split between the ranks and
    every rank gets the whole summary.  Returns (mean val stats, the
    evaluator's summary)."""
    mesh = mesh or DataMesh()
    from ..weights import load_reference_state_dict
    from .common import checkpoint_path, result_dir
    from .run import evaluate_frames, make_eval_lpips_fn

    cfg = cfg.merge_dict({"run_mode": "test", "perturb": 0.0})
    path = checkpoint_path(cfg, weights)
    ckpt = ckpt_io.read_checkpoint(path, cfg.vit_depth)
    if dataset is None:
        dataset = make_dataset(cfg, "test")
    model, pipe, _, _ = build_runtime(cfg, device, smpl=dataset.smpl,
                                      pe_table=ckpt["pe_table"])
    load_reference_state_dict(model, ckpt["net"])
    epoch = ckpt["epoch"]
    ev = EVALUATORS.get(cfg.evaluator)(
        result_dir(cfg), lpips_fn=make_eval_lpips_fn(cfg, device),
        exp_name=cfg.exp_name, epoch=epoch)
    recorder = Recorder(cfg.record_dir, cfg.record_interval, cfg.log_interval,
                        enabled=cfg.use_record and mesh.rank == 0)
    recorder.epoch = epoch

    def val_loss(item, out):
        # img2mse over the in-box rays (if_nerf_clight.py:77-81)
        err = out["rgb_map"] - item.eval_rays.rgb
        img_loss = float(np.mean(err * err))
        return {"img_loss": img_loss, "loss": img_loss}

    summary, val_stats = evaluate_frames(cfg, pipe, dataset, ev,
                                         per_frame=val_loss, tag="val ",
                                         mesh=mesh)
    print("  ".join(f"{k}: {v:.4f}" for k, v in val_stats.items()))
    print(summary, flush=True)
    recorder.record("val", extra={**val_stats, **{
        k: v for k, v in summary.items()
        if k not in ("experiment", "epoch") and isinstance(v, (int, float))
    }}, force=True)
    recorder.close()
    return val_stats, summary


def main(argv=None, dataset=None):
    """Training: returns (state, records), records one dict per step
    (losses, lr, data and step seconds; on an epoch's last step save_s,
    the seconds the save held the loop, and on the writing rank
    save_write_s, the seconds the checkpointer's worker took;
    the gradient all-reduce's ms and MB when distributed).  --test:
    returns validate's (val stats, summary).  dataset replaces
    make_dataset's."""
    args, cfg = parse_args(argv)
    # --test renders each frame over mesh_axis_rays cards a rank (local
    # rank l from card l*R); a train rank owns one card
    device = configure_device(args.device, args.dist_backend,
                              rays=cfg.mesh_axis_rays if args.test else 1)
    owns_group = maybe_init_distributed(args, device)
    try:
        if cfg.mesh_axis_model > 1:
            mesh = make_tp_train_mesh(cfg.mesh_axis_data,
                                      cfg.mesh_axis_model)
            world = mesh.world
        else:
            mesh = world = make_mesh(cfg.mesh_axis_data)
        if args.test:
            return validate(cfg, device, dataset, args.weights, world)
        return train(args, cfg, device, mesh, dataset)
    finally:
        if owns_group:
            shutdown()


def train(args, cfg: Config, device, mesh, dataset=None):
    """The train loop of main over mesh (a DataMesh or a TPMesh):
    (state, records).  Epochs are saved through an AsyncCheckpointer,
    whose writes are all on disk when this returns or raises."""
    checkpointer = ckpt_io.AsyncCheckpointer()
    try:
        return _train(args, cfg, device, mesh, dataset, checkpointer)
    finally:
        checkpointer.wait()


def _train(args, cfg: Config, device, mesh, dataset, checkpointer):
    seed_everything(cfg.seed)
    sharded = isinstance(mesh, TPMesh)
    data, world = (mesh.data, mesh.world) if sharded else (mesh, mesh)
    lead = world.rank == 0
    # the ranks that take part in a save: rank 0, and under TP the other
    # model ranks of its data index, which gather the whole state with it
    saves = lead or (sharded and data.rank == 0)
    mdir = model_dir(cfg)
    # read before the runtime is built: a converted checkpoint's stored PE
    # table rides into the pipeline and into every checkpoint this run writes
    ckpt = read_resume(cfg)
    state, step_fn, dataset, pipe = build_trainer(cfg, device, dataset, ckpt,
                                                  mesh=mesh)
    pe_table = ckpt["pe_table"] if ckpt else None
    recorder = Recorder(cfg.record_dir, cfg.record_interval, cfg.log_interval,
                        enabled=cfg.use_record and lead)
    start_epoch = 0
    if ckpt is not None:
        start_epoch = ckpt["epoch"] + 1
        recorder.load_state_dict(ckpt["recorder"])
        print(f"resumed from {ckpt['path']} at epoch {start_epoch}",
              flush=True)
    cap = args.steps or None
    max_iter = cfg.train.epoch * cfg.ep_iter
    records, prof, saved = [], None, []
    done = False
    for epoch in range(start_epoch, cfg.train.epoch):
        dataset.set_epoch(epoch)
        recorder.epoch = epoch
        # exactly ep_iter global batches per epoch, cycling a seeded
        # permutation: step it takes perm[it * G:(it + 1) * G] of G =
        # ranks x B samples, rank r the r-th B of them (the JAX CLI's
        # process slice)
        bsz = cfg.train.batch_size
        gsz = data.size * bsz
        need = cfg.ep_iter * gsz
        ep_rng = np.random.default_rng(cfg.seed + epoch)
        perm = np.concatenate([
            ep_rng.permutation(len(dataset))
            for _ in range(-(-need // len(dataset)))])[:need]
        lo = data.rank * bsz
        # workers build host samples (seeded by epoch and index, so their
        # order cannot change the data); the copy to the card stays here
        batches = Loader(
            lambda it: _timed_batch(
                dataset, perm[it * gsz:(it + 1) * gsz][lo:lo + bsz]),
            range(cfg.ep_iter),
            num_workers=(0 if cfg.train.num_workers <= 0
                         else cfg.train.num_workers + 1))
        # the JAX CLI's steady-state window: steps 5-8 of the first epoch,
        # shorter in a short epoch or run
        prof_stop = min(8, cfg.ep_iter - 1, (cap or cfg.ep_iter) - 1)
        prof_start = max(0, prof_stop - 3)
        profiling = cfg.profile_dir and epoch == start_epoch and lead
        t_end = time.perf_counter()
        for i, (host_batch, sample_s) in enumerate(batches):
            it = epoch * cfg.ep_iter + i
            if profiling and i == prof_start:
                prof = torch.profiler.profile(activities=_activities(device))
                prof.start()
            batch = [s.to(device) for s in host_batch]
            t1 = time.perf_counter()
            stats = step_fn(state, batch, fold_in(cfg.seed, it))
            _sync(device)
            t2 = time.perf_counter()
            rec = dict(stats, step=it, data_s=t1 - t_end, sample_s=sample_s,
                       step_s=t2 - t1, **(step_fn.comm or {}))
            records.append(rec)
            if prof is not None and i == prof_stop:
                prof.stop()
                _write_profile(cfg.profile_dir, prof,
                               records[-(prof_stop - prof_start + 1):])
                prof = None
            recorder.data_time.update(rec["data_s"])
            recorder.step = it
            recorder.batch_time.update(t2 - t_end)
            if i % cfg.log_interval == 0:
                recorder.update({k: v for k, v in stats.items()
                                 if k not in ("lr", "cull_survivors")})
                cull = (f"  cull_survivors: {stats['cull_survivors']:.4f}"
                        if pipe.train_cull else "")
                print(f"epoch {epoch} iter {i}/{cfg.ep_iter}  "
                      + recorder.console_line(max_iter, stats["lr"]) + cull,
                      flush=True)
            recorder.record("train")
            t_end = time.perf_counter()
            if cap and len(records) == cap:
                done = i + 1 < cfg.ep_iter  # a cut epoch is not saved
                break
        if done:
            break
        # the state is copied here; the serialising and the writes run on
        # the checkpointer's worker while the next epoch trains
        t0 = time.perf_counter()
        if saves:
            paths = checkpointer.save_epoch(
                mdir, state, epoch, (epoch + 1) % cfg.save_freq == 0,
                recorder.state_dict(), pe_table, write=lead)
            if lead:
                print(f"checkpoint: {', '.join(paths)} (queued in "
                      f"{time.perf_counter() - t0:.3f} s)", flush=True)
        barrier(world)
        records[-1]["save_s"] = time.perf_counter() - t0
        saved.append((records[-1], epoch))
        if cap and len(records) == cap:
            break
    # every epoch's files are on disk before the --out save and before any
    # rank leaves (another rank's --test reads latest.pth next)
    checkpointer.wait()
    barrier(world)
    for rec, epoch in saved:
        if epoch in checkpointer.write_s:
            rec["save_write_s"] = checkpointer.write_s[epoch]
    if args.out and records:
        if saves:
            ckpt_io.save_checkpoint(args.out, state, records[-1]["step"]
                                    // cfg.ep_iter, recorder.state_dict(),
                                    pe_table, write=lead)
            if lead:
                print(f"checkpoint: {args.out}", flush=True)
        barrier(world)
    recorder.close()
    if world.distributed:
        extra = {}
        if sharded:
            extra = dict(
                tp.vit_bytes(state), vit_digest=tp.vit_digest(state.model),
                replicated_digest=tp.replicated_digest(state.model),
                data_rank=data.rank, model_rank=mesh.model.rank,
                model_allreduce_count=[r["model_allreduce_count"]
                                       for r in records],
                model_allreduce_ms=[r["model_allreduce_ms"]
                                    for r in records])
        rank_report(world, step_ms=[r["step_s"] * 1e3 for r in records],
                    loss=[r["loss"] for r in records],
                    grad_allreduce_ms=[r.get("grad_allreduce_ms", 0.0)
                                       for r in records],
                    grad_allreduce_mb=records[0].get("grad_allreduce_mb",
                                                     0.0)
                    if records else 0.0, **extra)
    return state, records


if __name__ == "__main__":
    main()
