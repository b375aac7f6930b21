"""Training checkpoints with the reference's lifecycle
(``lib/utils/net_utils.py``; counterpart of transhuman_tpu/train/checkpoint.py).

The port writes the reference's ``.pth`` layout: ``{'net': state_dict,
'optim': ..., 'scheduler': ..., 'epoch': N, 'step': S, 'recorder': {...}}``
plus ``pe_table`` when the run carries a stored TransHE table.  Each epoch
writes ``latest.pth`` and, every ``save_freq`` epochs, ``{epoch}.pth``; the
files are serialised once and written atomically (temporary file, then
rename).  ``weights.load_checkpoint_file`` reads the 'net' part, so a trained
model serves as it is.  The train entry point saves through
``AsyncCheckpointer`` (the JAX package's class of that name): the state is
copied at once, and the serialising and the writes run on one worker
thread, off the train loop, in the order of the saves.  A tensor-parallel state (``parallel/tp.py``) is
written whole: its model ranks gather the reference state dict and the
optimizer's moments (every model rank must take part), and one rank
writes, so the file is the one a single process writes; a run resumes
from it, or from a single process's file, by restoring the whole state
and sharding it after (``tp.shard_train_state_``).

It also reads the JAX package's ``latest.ckpt`` / ``ep{N}.ckpt`` without
JAX: a pickle of a numpy-ified pytree holding optax state, unpickled by
``_CkptUnpickler``, whose ``find_class`` maps the optax and flax classes
such a file names to stand-ins and numpy's array constructors to numpy's,
and refuses every other global (loading a pickle runs code).  Its
parameters and Adam moments go through ``weights.state_dict_from_jax``;
optax's update count becomes torch's ``step``, and the scheduler is placed
so that update k uses lr(k), as optax's schedule does.
"""

from __future__ import annotations

import copy
import io
import os
import pickle
import re
import time
from collections import deque, namedtuple
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .step import TrainState


# ------------------------------------------------------------------ write
def _atomic_write(path: str, data: bytes):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def checkpoint_blob(state: TrainState, epoch: int, recorder: Optional[dict]
                    = None, pe_table=None) -> dict:
    """The file's dict; a sharded state's whole one (every model rank of
    it must call this)."""
    from ..parallel import tp

    blob = {
        "net": tp.gather_state_dict(state.model),
        "optim": tp.gather_optimizer_state(state),
        "scheduler": state.scheduler.state_dict(),
        "epoch": int(epoch),
        "step": int(state.step),
        "recorder": dict(recorder or {}),
    }
    if pe_table is not None:
        blob["pe_table"] = torch.as_tensor(np.asarray(pe_table, np.float32))
    return blob


def _serialise(blob: dict) -> bytes:
    buf = io.BytesIO()
    torch.save(blob, buf)
    return buf.getvalue()


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    recorder: Optional[dict] = None, pe_table=None,
                    write: bool = True):
    """One checkpoint file at path; with write False only the gather of a
    sharded state is taken part in."""
    blob = checkpoint_blob(state, epoch, recorder, pe_table)
    if write:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        _atomic_write(path, _serialise(blob))


def _epoch_paths(model_dir: str, epoch: int, save_epoch_copy: bool) -> list:
    paths = [os.path.join(model_dir, "latest.pth")]
    if save_epoch_copy:
        paths.append(os.path.join(model_dir, f"{epoch}.pth"))
    return paths


def _write_blob(blob: dict, paths: list):
    """Serialise once, write each path atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(paths[0])), exist_ok=True)
    data = _serialise(blob)
    for p in paths:
        _atomic_write(p, data)


def save_epoch(model_dir: str, state: TrainState, epoch: int,
               save_epoch_copy: bool, recorder: Optional[dict] = None,
               pe_table=None, write: bool = True) -> list:
    """``latest.pth``, and ``{epoch}.pth`` when save_epoch_copy, in
    model_dir (JAX cli/train.py:347-351); returns the paths written (none
    with write False, which only takes part in a sharded state's
    gather)."""
    blob = checkpoint_blob(state, epoch, recorder, pe_table)
    if not write:
        return []
    paths = _epoch_paths(model_dir, epoch, save_epoch_copy)
    _write_blob(blob, paths)
    return paths


class AsyncCheckpointer:
    """``save_epoch`` off the train loop (the JAX package's
    ``AsyncCheckpointer``).  ``save_epoch`` takes a copy of the whole state
    at once (``copy.deepcopy`` of the file's dict: the optimizer and the
    model update their tensors in place, and ``.cpu()`` of a CPU tensor is
    no copy), then hands it to one worker thread, which serialises it and
    writes the files as ``save_epoch`` does, byte for byte.  One worker
    keeps the saves in order, so ``latest.pth`` never goes back to an
    older epoch.  A worker's error is raised at the next ``save_epoch`` or
    ``wait``.  At most ``MAX_PENDING`` copies wait to be written: a save
    past that blocks on the oldest write, as the JAX class does, so a slow
    disk stalls the loop instead of filling the host's memory.  Call
    ``wait`` before anything reads the files and before the process ends.
    ``write_s`` maps each epoch written to the seconds its worker took."""

    MAX_PENDING = 2

    def __init__(self):
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="checkpoint")
        self._pending = deque()
        self.write_s = {}

    def _write(self, blob: dict, paths: list, epoch: int):
        t0 = time.perf_counter()
        _write_blob(blob, paths)
        self.write_s[epoch] = time.perf_counter() - t0

    def _drain(self, block: bool):
        """Collect the finished writes (all of them when block), raising
        the first error among them."""
        while self._pending and (block or self._pending[0].done()):
            self._pending.popleft().result()

    def save_epoch(self, model_dir: str, state: TrainState, epoch: int,
                   save_epoch_copy: bool, recorder: Optional[dict] = None,
                   pe_table=None, write: bool = True) -> list:
        """As the module's ``save_epoch``, the writes queued: returns the
        paths to be written.  With write False it only takes part in a
        sharded state's gather (every model rank must call it)."""
        self._drain(block=False)
        while len(self._pending) >= self.MAX_PENDING:
            self._pending.popleft().result()
        blob = copy.deepcopy(checkpoint_blob(state, epoch, recorder,
                                             pe_table))
        if not write:
            return []
        paths = _epoch_paths(model_dir, epoch, save_epoch_copy)
        self._pending.append(self._ex.submit(self._write, blob, paths,
                                             epoch))
        return paths

    def wait(self):
        """Block until every queued write is on disk; raise a worker's
        error."""
        self._drain(block=True)


# ------------------------------------------------------------------- find
def _epochs(model_dir: str, pattern: str):
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(pattern, f) for f in os.listdir(model_dir))
                  if m)


def find_checkpoint(model_dir: str, epoch: int = -1) -> Optional[str]:
    """The checkpoint of ``epoch`` in model_dir, or None: for -1 the
    port's ``latest.pth``, else its highest ``{N}.pth``, else the JAX
    package's ``latest.ckpt``, else its highest ``ep{N}.ckpt`` (JAX
    train/checkpoint.py:153-178); for N ``N.pth``, else ``epN.ckpt``."""
    if epoch >= 0:
        names = [f"{epoch}.pth", f"ep{epoch}.ckpt"]
    else:
        names = ["latest.pth"]
        names += [f"{e}.pth" for e in _epochs(model_dir, r"(\d+)\.pth")[-1:]]
        names += ["latest.ckpt"]
        names += [f"ep{e}.ckpt"
                  for e in _epochs(model_dir, r"ep(\d+)\.ckpt")[-1:]]
    for name in names:
        path = os.path.join(model_dir, name)
        if os.path.isfile(path):
            return path
    return None


# ------------------------------------------------------- the JAX's .ckpt
# stand-ins for the optax states a JAX checkpoint pickles (namedtuples
# there too, built from their fields)
EmptyState = namedtuple("EmptyState", [])
ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
ScaleByScheduleState = namedtuple("ScaleByScheduleState", ["count"])
TraceState = namedtuple("TraceState", ["trace"])
_OPTAX = {c.__name__: c for c in (EmptyState, ScaleByAdamState,
                                  ScaleByScheduleState, TraceState)}


def _frozen_dict(*args, **kw):
    return dict(*args, **kw)


def _numpy_globals() -> dict:
    """numpy's array and scalar constructors, under the module names of
    numpy 1 (numpy.core) and numpy 2 (numpy._core) alike."""
    import importlib

    out = {("numpy", "dtype"): np.dtype, ("numpy", "ndarray"): np.ndarray}
    for sub in ("multiarray", "numeric"):
        for pkg in ("numpy._core", "numpy.core"):
            try:
                mod = importlib.import_module(f"{pkg}.{sub}")
            except ImportError:
                continue
            for name in ("_reconstruct", "scalar", "_frombuffer"):
                obj = getattr(mod, name, None)
                if obj is not None:
                    out[(f"numpy.core.{sub}", name)] = obj
                    out[(f"numpy._core.{sub}", name)] = obj
            break
    return out


_NUMPY = _numpy_globals()


class _CkptUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NUMPY:
            return _NUMPY[(module, name)]
        if module.split(".")[0] == "optax" and name in _OPTAX:
            return _OPTAX[name]
        if module.startswith("flax.") and name == "FrozenDict":
            return _frozen_dict
        raise pickle.UnpicklingError(
            f"refusing global {module}.{name} in a checkpoint: a JAX "
            "checkpoint names only numpy, optax and flax state classes")


def load_jax_ckpt(path: str) -> dict:
    """The pytree of a JAX package ``.ckpt`` (numpy leaves, stand-in optax
    states)."""
    with open(path, "rb") as f:
        return _CkptUnpickler(f).load()


def _walk_states(tree):
    if isinstance(tree, tuple) and type(tree).__name__ in _OPTAX:
        yield tree
        return
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _walk_states(t)


def _jax_optimizer(opt_state, vit_depth: int) -> dict:
    """{'count', and 'mu'/'nu' or 'trace' as reference-layout state dicts}
    from an optax chain state."""
    from ..weights import live_state_dict, state_dict_from_jax

    def sd(tree):
        return live_state_dict(state_dict_from_jax(tree["params"], vit_depth))

    out = {}
    for st in _walk_states(opt_state):
        if isinstance(st, ScaleByAdamState):
            out.update(mu=sd(st.mu), nu=sd(st.nu), count=int(st.count))
        elif isinstance(st, TraceState):
            out.update(trace=sd(st.trace))
        elif isinstance(st, ScaleByScheduleState):
            out["count"] = int(st.count)
    if "count" not in out or not ({"mu", "trace"} & set(out)):
        raise ValueError("a JAX checkpoint's opt_state holds no Adam or SGD "
                         "state the port maps")
    return out


def read_checkpoint(path: str, vit_depth: int) -> dict:
    """A port ``.pth`` or a JAX ``.ckpt`` as {'net': reference-layout state
    dict, 'epoch', 'step', 'recorder', 'pe_table' (numpy or None), and
    'optim'/'scheduler' (a port file's) or 'jax_optim' (a JAX file's), each
    None when absent}."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    if path.endswith(".ckpt"):
        from ..weights import state_dict_from_jax

        ck = load_jax_ckpt(path)
        pe = ck.get("pe_table")
        return {
            "net": state_dict_from_jax(ck["params"]["params"], vit_depth),
            "epoch": int(np.asarray(ck.get("epoch", -1))),
            "step": int(np.asarray(ck.get("step", 0))),
            "recorder": {k: int(np.asarray(v)) for k, v in
                         ck.get("recorder", {}).items()},
            "pe_table": None if pe is None else np.asarray(pe, np.float32),
            "optim": None, "scheduler": None,
            "jax_optim": (_jax_optimizer(ck["opt_state"], vit_depth)
                          if "opt_state" in ck else None),
        }
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or "net" not in blob:
        blob = {"net": blob}
    pe = blob.get("pe_table")
    return {
        "net": blob["net"], "epoch": int(blob.get("epoch", -1)),
        "step": int(blob.get("step", 0)),
        "recorder": dict(blob.get("recorder", {})),
        "pe_table": None if pe is None else pe.numpy(),
        "optim": blob.get("optim"), "scheduler": blob.get("scheduler"),
        "jax_optim": None,
    }


# ---------------------------------------------------------------- restore
def place_scheduler(state: TrainState, count: int):
    """Put the scheduler (and the optimizer's lr) where the next update,
    update ``count``, uses lr(count): optax evaluates its schedule at the
    count before incrementing it."""
    sch = state.scheduler
    sch.last_epoch = count
    lrs = [base * fn(count) for base, fn in zip(sch.base_lrs,
                                                 sch.lr_lambdas)]
    for g, lr in zip(state.optimizer.param_groups, lrs):
        g["lr"] = lr
    sch._last_lr = lrs


def _load_jax_optimizer(state: TrainState, jopt: dict):
    opt = state.optimizer
    names = [n for n, _ in state.model.named_parameters()]
    order = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])}
    params = dict(state.model.named_parameters())
    per = {}
    for n in names:
        if "mu" in jopt:
            per[order[id(params[n])]] = {
                "step": torch.tensor(float(jopt["count"])),
                "exp_avg": jopt["mu"][n].clone(),
                "exp_avg_sq": jopt["nu"][n].clone()}
        else:
            per[order[id(params[n])]] = {
                "momentum_buffer": jopt["trace"][n].clone()}
    opt.load_state_dict({"state": per,
                         "param_groups": opt.state_dict()["param_groups"]})
    place_scheduler(state, jopt["count"])


def restore(state: TrainState, ckpt: dict):
    """Load a read_checkpoint result into state: weights, optimizer,
    scheduler and step.  A weights-only file starts the optimizer fresh."""
    from ..weights import load_reference_state_dict

    load_reference_state_dict(state.model, ckpt["net"])
    if ckpt["optim"] is not None:
        state.optimizer.load_state_dict(ckpt["optim"])
        state.scheduler.load_state_dict(ckpt["scheduler"])
    elif ckpt["jax_optim"] is not None:
        _load_jax_optimizer(state, ckpt["jax_optim"])
    else:
        print("checkpoint has no opt_state (weights-only / converted): "
              "starting optimizer state fresh", flush=True)
    state.step = int(ckpt["step"])


def load_checkpoint(path: str, state: TrainState) -> int:
    """Restore a checkpoint file into ``state``; returns its epoch."""
    depth = len(state.model.ViT.blocks)
    ckpt = read_checkpoint(path, depth)
    restore(state, ckpt)
    return ckpt["epoch"]
