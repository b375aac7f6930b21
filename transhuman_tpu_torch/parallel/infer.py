"""Ray-sharded frame render over several devices of one process
(counterpart of transhuman_tpu/parallel/infer.py, ``mesh_axis_rays``).

Once a frame's prologue is made its rays are independent, so the rays are
split into R contiguous shares, one for each device, and the weights and
the frame are replicated: every replica makes the prologue itself, so no
collective runs on the hot path (the JAX package's choice).  Share s is
rendered by replica s on a worker thread of its own, under its device:
``render_frame`` waits on the host at every chunk's compaction, so a loop
over the devices would run them one after another.  One process drives
its R devices, as the JAX process drives its local devices, which leaves
torchrun's frame sharding (parallel/mesh.py) as it is.

Every share boundary sits on a multiple of ``chunk_rays``, and
``render_frame`` culls and compacts per chunk, so each chunk holds the
rays it holds without sharding: the maps equal one device's bit for bit
where the devices compute alike.
"""

from __future__ import annotations

import contextlib
import copy
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import fields

import torch

from ..render.pipeline import RayBundle


def ray_devices(device, r: int) -> list:
    """The R devices a ray-sharded render on ``device``'s kind uses: on the
    card ``cuda:(base + i)`` for i < R, base = LOCAL_RANK·R under torchrun
    and 0 otherwise; on the CPU R entries of ``cpu``.  Fewer cards than
    base + R is a SystemExit that gives the counts: the render never runs
    with fewer shares."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.device("cpu")] * r
    local = int(os.environ.get("LOCAL_RANK", 0))
    cards = torch.cuda.device_count()
    if cards < (local + 1) * r:
        raise SystemExit(
            f"mesh_axis_rays={r} on local rank {local} needs cards "
            f"{local * r}..{(local + 1) * r - 1}, but {cards} CUDA card(s) "
            "are visible")
    return [torch.device("cuda", local * r + i) for i in range(r)]


def _concrete(device) -> torch.device:
    """``cuda`` without an index as the card it means."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def replicate(pipe, devices) -> list:
    """One replica of ``pipe`` for each entry of ``devices``, each with a
    ``last_frame_stats`` of its own.  A replica on the pipe's own device
    shares its model and device tables; on another device the model and
    the tables (``pool``, ``pe_can``, the vertex radii) are copied there,
    once for each such device.  The weights are copied as they stand now:
    load a checkpoint before replicating."""
    home = _concrete(pipe.device)
    moved = {}
    out = []
    for d in map(_concrete, devices):
        if d == home:
            out.append(pipe.clone())
            continue
        if d not in moved:
            vr = pipe.vertex_radii
            moved[d] = dict(
                model=copy.deepcopy(pipe.model).to(d), device=d,
                pool=pipe.pool.to(d), pe_can=pipe.pe_can.to(d),
                _vertex_radii=None if vr is None else vr.to(d))
        out.append(pipe.clone(**moved[d]))
    return out


def share_bounds(n_rays: int, chunk_rays: int, r: int) -> list:
    """[(a, b)] of R contiguous shares of n_rays rays: every boundary on a
    multiple of chunk_rays, the shares' chunk counts within one of each
    other; a share is empty when there are fewer chunks than shares."""
    chunks = -(-n_rays // chunk_rays)
    cuts = [min(s * chunks // r * chunk_rays, n_rays) for s in range(r + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def _on(device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def make_sharded_render(pipe, devices):
    """render(frame, rays) -> maps of ``pipe.render_frame`` over the R =
    len(devices) entries of ``devices`` (an entry may repeat a device): the
    replicas are built here, once; each call splits the rays (share_bounds),
    renders share s on replica s in a thread of its own, and returns the
    maps concatenated on devices[0] in ray order.  The replicas'
    ``last_frame_stats`` are summed into ``pipe.last_frame_stats``.  An
    exception in any share is raised here, after every share has ended;
    no partial frame is returned."""
    replicas = replicate(pipe, devices)

    def run(rep, frame, rays, a, b):
        with _on(rep.device):
            share = RayBundle(**{f.name: getattr(rays, f.name)[a:b].to(
                rep.device) for f in fields(RayBundle)})
            return rep.render_frame(frame.to(rep.device), share)

    def render(frame, rays):
        bounds = share_bounds(rays.ray_o.shape[0], pipe.chunk_rays,
                              len(replicas))
        jobs = [(rep, a, b) for rep, (a, b) in zip(replicas, bounds)
                if b > a] or [(replicas[0], 0, 0)]
        with ThreadPoolExecutor(len(jobs),
                                thread_name_prefix="ray-share") as pool:
            futures = [pool.submit(run, rep, frame, rays, a, b)
                       for rep, a, b in jobs]
        outs = [f.result() for f in futures]  # the first share's error
        pipe.last_frame_stats = {
            k: sum(rep.last_frame_stats[k] for rep, _, _ in jobs)
            for k in ("points", "survivors")}
        home = replicas[0].device
        return {k: torch.cat([o[k].to(home) for o in outs])
                for k in outs[0]}

    return render
