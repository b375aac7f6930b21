"""Training checkpoints in the reference's ``.pth`` layout
(``lib/utils/net_utils.py::save_model``):
``{'net': state_dict, 'optim': ..., 'scheduler': ..., 'epoch': N}``.

``weights.load_checkpoint_file`` reads the 'net' part back, so a trained
model serves as it is (``python -m transhuman_tpu_torch.serve --weights``).
Files are written atomically (temporary file, then rename).
"""

from __future__ import annotations

import os

import torch

from .step import TrainState


def save_checkpoint(path: str, state: TrainState, epoch: int):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blob = {
        "net": {k: v.detach().cpu()
                for k, v in state.model.state_dict().items()},
        "optim": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "epoch": int(epoch),
        "step": int(state.step),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state: TrainState) -> int:
    """Restore model, optimizer, scheduler and step into ``state``; returns
    the epoch."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(blob["net"], strict=True)
    state.optimizer.load_state_dict(blob["optim"])
    state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(blob.get("step", 0))
    return int(blob["epoch"])
