"""Persistent render serving on the PyTorch port (counterpart of
transhuman_tpu/serve.py, with the same HTTP contract).

Run: ``python -m transhuman_tpu_torch.serve --weights w.pth [--device cuda]
[--host 127.0.0.1] [--port 8008] [--no_warmup] [key value ...]`` where
``w.pth`` is a reference-layout checkpoint (``transhuman_tpu/tools/
export_checkpoint.py`` output or an official one) and ``key value`` pairs
override config.py's defaults.

Endpoints
---------
``GET /healthz``  JSON: status, devices (a list of one), the network's
    compute dtype (``float32`` or ``bfloat16``), parameter count; the JAX
    service's TPU-only ``ray_bucket`` and ``compact_ratio`` are not
    carried.
``GET /stats``    JSON: render count, latency mean/p50/p95 (ms).
``POST /render``  Body: an ``.npz`` archive with ``images (V,H,W,3)`` (float
    in [0,1] or any integer type), per-view ``K/R/T``, the target camera
    ``tK (3,3) / tR (3,3) / tT (3,)`` and the body as ``verts_world (Nv,3)`` +
    ``blend_rot (Nv,3,3)`` or as SMPL ``poses (72,)`` + ``shapes (10,)``.
    Optional: ``masks (V,H,W)``, ``vizmaps (V,Nv)``, ``Rh (3,3)``,
    ``Th (3,)``, ``H``/``W``.  Reply: ``.npz`` with ``rgb (H,W,3)``,
    ``depth (H,W)``, ``acc (H,W)``, or a PNG of rgb with ``?format=png``.
    A malformed request is a 400; a full queue a 503 with Retry-After.

HTTP threads put requests on a bounded queue that one executor thread drains
(the card runs one frame at a time); the executor renders and replies to
each request before it takes the next off the queue.
"""

from __future__ import annotations

import io
import json
import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .cli.run import FrameRenderer
from .config import Config
from .data.ray_sampling import sample_eval_rays
from .geometry.rays import world_bounds
from .render.pipeline import FrameInputs
from .utils.png import encode_png


class RequestError(ValueError):
    """Bad client payload (HTTP 400)."""


class OverloadedError(RuntimeError):
    """Server saturated (HTTP 503 + Retry-After): retry elsewhere or later."""


def _as_f32(d, key, shape_hint=None):
    if key not in d:
        raise RequestError(f"missing required array {key!r}"
                           + (f" {shape_hint}" if shape_hint else ""))
    try:
        return np.asarray(d[key], np.float32)
    except (ValueError, TypeError) as e:
        raise RequestError(f"array {key!r} is not numeric: {e}") from e


def _shaped(d, key, shape):
    a = _as_f32(d, key, str(shape))
    try:
        return a.reshape(shape)
    except ValueError as e:
        raise RequestError(
            f"{key} has shape {a.shape}; cannot reshape to {shape}") from e


def parse_render_request(arrays: dict, cfg: Config, smpl) -> tuple:
    """npz dict -> (FrameInputs of CPU tensors, (tK, tR, tT), (H, W))."""
    imgs = _as_f32(arrays, "images", "(V,H,W,3)")
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise RequestError(f"images must be (V,H,W,3), got {imgs.shape}")
    kind = np.asarray(arrays["images"]).dtype
    if kind.kind in "iu":  # any integer type is a [0, max] image
        imgs = imgs / float(np.iinfo(kind).max)
    v = imgs.shape[0]
    K = _shaped(arrays, "K", (v, 3, 3))
    R = _shaped(arrays, "R", (v, 3, 3))
    T = _shaped(arrays, "T", (v, 3))
    if "masks" in arrays:
        m = np.asarray(arrays["masks"]) != 0
        if m.shape != imgs.shape[:3]:
            raise RequestError(
                f"masks {m.shape} must match images[:3] {imgs.shape[:3]}")
        if cfg.mask_bkgd:
            bg = 1.0 if cfg.white_bkgd else 0.0
            imgs = np.where(m[..., None], imgs, np.float32(bg))
    Rh = (_shaped(arrays, "Rh", (3, 3)) if "Rh" in arrays
          else np.eye(3, dtype=np.float32))
    Th = (_shaped(arrays, "Th", (3,)) if "Th" in arrays
          else np.zeros(3, np.float32))

    if "verts_world" in arrays:
        verts_world = _shaped(arrays, "verts_world", (-1, 3))
        blend_rot = _shaped(arrays, "blend_rot", (-1, 3, 3))
        if blend_rot.shape[0] != verts_world.shape[0]:
            raise RequestError("blend_rot rows != verts_world rows")
    elif "poses" in arrays:
        n_shape = smpl.shapedirs.shape[-1]
        verts_smpl, _, blend = smpl(_shaped(arrays, "poses", (72,)),
                                    _shaped(arrays, "shapes", (n_shape,)))
        verts_world = (verts_smpl @ Rh.T + Th).astype(np.float32)
        blend_rot = blend[:, :3, :3].astype(np.float32)
    else:
        raise RequestError("need either verts_world+blend_rot or poses+shapes")
    nv = verts_world.shape[0]
    if nv != smpl.v_template.shape[0]:
        raise RequestError(f"verts_world has {nv} vertices; the served model "
                           f"uses {smpl.v_template.shape[0]}")
    vizmaps = (_shaped(arrays, "vizmaps", (v, nv)) if "vizmaps" in arrays
               else np.ones((v, nv), np.float32))
    verts_smpl_t = ((verts_world - Th) @ Rh).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    frame = FrameInputs(
        images=t(imgs), vizmaps=t(vizmaps), K=t(K), R=t(R), T=t(T),
        verts_world=t(verts_world), tar_verts_smpl=t(verts_smpl_t),
        blend_rot=t(blend_rot), Rh=t(Rh), Th=t(Th),
    )
    tK = _shaped(arrays, "tK", (3, 3))
    tR = _shaped(arrays, "tR", (3, 3))
    tT = _shaped(arrays, "tT", (3,))

    def _scalar_int(key, default):
        if key not in arrays:
            return default
        try:
            return int(np.asarray(arrays[key]).reshape(()))
        except (ValueError, TypeError) as e:
            raise RequestError(f"{key} must be a scalar int: {e}") from e

    H = _scalar_int("H", cfg.H_render)
    W = _scalar_int("W", cfg.W_render)
    if not (8 <= H <= 8192 and 8 <= W <= 8192):
        raise RequestError(f"unreasonable resolution {H}x{W}")
    return frame, (tK, tR, tT), (H, W)


class RenderService:
    """One model on one device; single-threaded (RenderServer serialises)."""

    def __init__(self, cfg: Config, pipe, smpl):
        self.cfg = cfg
        self.pipe = pipe
        self.smpl = smpl
        self.renderer = FrameRenderer(cfg, pipe)
        self.n_rendered = 0
        self.latencies_ms: "deque" = deque(maxlen=1024)

    def dispatch(self, arrays: dict):
        frame, (tK, tR, tT), (H, W) = parse_render_request(
            arrays, self.cfg, self.smpl)
        er = sample_eval_rays(
            None, tK, tR, tT.reshape(3, 1),
            world_bounds(frame.verts_world.numpy(), self.cfg.big_box),
            hw=(H, W),
        )
        if er.rays.ray_o.shape[0] == 0:
            raise RequestError("target camera sees no part of the body AABB")
        return self.renderer.dispatch(frame, er), er, (H, W)

    def fetch(self, dispatched) -> dict:
        dev, er, (H, W) = dispatched
        out = self.renderer.fetch(dev)
        rgb = np.zeros((H * W, 3), np.float32)
        depth = np.zeros(H * W, np.float32)
        acc = np.zeros(H * W, np.float32)
        rgb[er.pix_idx] = out["rgb_map"]
        depth[er.pix_idx] = out["depth_map"]
        acc[er.pix_idx] = out["acc_map"]
        if self.cfg.white_bkgd:
            rgb[~er.mask_at_box] = 1.0
        self.n_rendered += 1
        return {"rgb": rgb.reshape(H, W, 3), "depth": depth.reshape(H, W),
                "acc": acc.reshape(H, W)}

    def render(self, arrays: dict) -> dict:
        return self.fetch(self.dispatch(arrays))

    def warmup(self, H: int, W: int, n_views: int = 3):
        """Render one T-pose frame at 2.5 m so the first request pays no
        one-off cost (kernel build, allocator growth); not counted."""
        verts, _, blend = self.smpl(np.zeros(72), np.zeros(10))
        focal = 0.9 * max(H, W)
        K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                     np.float32)
        req = {
            "images": np.zeros((n_views, H, W, 3), np.float32),
            "K": np.tile(K, (n_views, 1, 1)),
            "R": np.tile(np.eye(3, dtype=np.float32), (n_views, 1, 1)),
            "T": np.tile(np.array([0, 0, 2.5], np.float32), (n_views, 1)),
            "verts_world": verts, "blend_rot": blend[:, :3, :3],
            "tK": K, "tR": np.eye(3, dtype=np.float32),
            "tT": np.array([0, 0, 2.5], np.float32), "H": H, "W": W,
        }
        t0 = time.perf_counter()
        self.render(req)
        self.n_rendered -= 1
        print(f"serve: warmup render {H}x{W} in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    def stats(self) -> dict:
        lat = np.asarray(list(self.latencies_ms), np.float64)

        def q(p):
            return float(np.percentile(lat, p)) if lat.size else 0.0

        return {"renders": self.n_rendered,
                "latency_ms": {"mean": float(lat.mean()) if lat.size else 0.0,
                               "p50": q(50), "p95": q(95)}}


_STOP = object()
ENQUEUE_WAIT_S = 30.0  # how long a request waits for a queue slot before 503


class RenderServer:
    """HTTP front + one executor thread."""

    def __init__(self, service: RenderService, host="127.0.0.1", port=0,
                 max_queue: int = 8):
        self.service = service
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.port = self.httpd.server_address[1]

    def _run(self):
        """Take each request off the queue, render it and deliver its reply
        before taking the next: dispatch waits on the card at every chunk's
        compaction, so a request dispatched ahead would overlap nothing and
        delay this one's reply."""
        svc = self.service
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            fut, arrays, t0 = item
            # a client that gave up cancelled its future: skip the work
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                out = svc.fetch(svc.dispatch(arrays))
                svc.latencies_ms.append((time.perf_counter() - t0) * 1e3)
                fut.set_result(out)
            except Exception as e:  # noqa: BLE001 — goes to the client
                fut.set_exception(e)

    def submit(self, arrays: dict) -> Future:
        fut: Future = Future()
        try:
            self._q.put((fut, arrays, time.perf_counter()),
                        timeout=ENQUEUE_WAIT_S)
        except queue.Full:
            fut.set_exception(
                OverloadedError("render queue full — server overloaded"))
        return fut

    def start(self):
        self._worker.start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def serve_forever(self):
        self._worker.start()
        self.httpd.serve_forever()

    def shutdown(self):
        """Stop the HTTP loop and the executor; queued work gets a 503."""
        self.httpd.shutdown()
        self.httpd.server_close()
        while True:
            try:
                self._q.put_nowait(_STOP)
                break
            except queue.Full:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    continue
                if item is not _STOP and not item[0].cancelled():
                    item[0].set_exception(
                        OverloadedError("server shutting down"))
        if self._worker.is_alive():
            self._worker.join(timeout=60)


def _make_handler(server: RenderServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 — stats carry it
            pass

        def _reply(self, code: int, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            for k, v in extra:
                self.send_header(k, v)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj: dict, extra=()):
            self._reply(code, json.dumps(obj).encode(), "application/json",
                        extra)

        def do_GET(self):  # noqa: N802
            svc = server.service
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "devices": [str(svc.pipe.device)],
                    "compute_dtype": str(
                        svc.pipe.model.compute_dtype).removeprefix("torch."),
                    "n_params": sum(p.numel()
                                    for p in svc.pipe.model.parameters()),
                })
            elif self.path == "/stats":
                self._json(200, svc.stats())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            path, _, query = self.path.partition("?")
            if path != "/render":
                self._json(404, {"error": f"unknown path {path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0 or n > 1 << 31:
                    raise RequestError(f"bad Content-Length {n}")
                try:
                    arrays = dict(np.load(io.BytesIO(self.rfile.read(n)),
                                          allow_pickle=False))
                except Exception as e:  # malformed client bytes -> 400
                    raise RequestError(f"body is not a readable npz: {e}")
                fut = server.submit(arrays)
                try:
                    out = fut.result(timeout=600)
                except FuturesTimeout:
                    fut.cancel()
                    raise OverloadedError("render timed out after 600 s")
            except RequestError as e:
                self._json(400, {"error": str(e)})
                return
            except OverloadedError as e:
                self._json(503, {"error": str(e)}, (("Retry-After", "30"),))
                return
            except Exception as e:  # noqa: BLE001 — surfaced, not hidden
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if query == "format=png":
                self._reply(200, encode_png(out["rgb"]), "image/png")
                return
            buf = io.BytesIO()
            np.savez_compressed(buf, **out)
            self._reply(200, buf.getvalue(), "application/octet-stream")

    return Handler


def main(argv=None) -> int:
    import argparse

    from .cli.common import build_runtime, configure_device
    from .weights import load_checkpoint_file

    p = argparse.ArgumentParser(prog="python -m transhuman_tpu_torch.serve")
    p.add_argument("--weights", required=True,
                   help="reference-layout .pth checkpoint")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="config overrides: key value ...")
    args = p.parse_args(argv)
    cfg = Config().merge_opts(args.opts)
    device = configure_device(args.device)
    model, pipe, smpl, _ = build_runtime(cfg, device)
    epoch = load_checkpoint_file(model, args.weights)
    print(f"serve: {args.weights} (epoch {epoch}) on {device}, "
          f"{args.host}:{args.port}", file=sys.stderr)
    svc = RenderService(cfg, pipe, smpl)
    if not args.no_warmup:
        svc.warmup(cfg.H_render, cfg.W_render,
                   n_views=max(1, len(cfg.test.input_view)))
    server = RenderServer(svc, host=args.host, port=args.port)
    print(f"serve: listening on http://{args.host}:{server.port}  "
          "(GET /healthz, GET /stats, POST /render)", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
