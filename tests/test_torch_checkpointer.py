"""The train entry point's checkpoints written off the train loop
(``train/checkpoint.py::AsyncCheckpointer``, the JAX package's class of
that name): the files byte for byte those of ``save_epoch``, a copy taken
at the save that later in-place updates do not reach, saves written in
order behind a slow disk with at most two copies waiting, and a worker's
error raised at the next save or wait."""

import os
import threading
import time

import pytest
import torch

from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.train import checkpoint as ckpt_io
from transhuman_tpu_torch.train import step as tstep


def _state(seed=0):
    """A small model with one Adam update taken, so that the optimizer
    holds moments."""
    torch.manual_seed(seed)
    net = TransHumanNet(embed_dim=12, vit_depth=1, vit_heads=2, knn_k=3)
    opt, sched = tstep.make_optimizer(net.parameters(), iters_per_epoch=4)
    for p in net.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    sched.step()
    state = tstep.TrainState(net, opt, sched)
    state.step = 1
    return state


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _update_in_place(state):
    """What the next train step does to the live tensors."""
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for st in state.optimizer.state.values():
            st["exp_avg"].mul_(3.0)


@pytest.fixture
def slow_writes(monkeypatch):
    """The checkpointer worker's writes wait until the returned event is
    set (the test's own save_epoch calls write at once)."""
    gate = threading.Event()
    write = ckpt_io._write_blob

    def gated(blob, paths):
        if threading.current_thread().name.startswith("checkpoint"):
            assert gate.wait(30), "the test never released the writer"
        write(blob, paths)

    monkeypatch.setattr(ckpt_io, "_write_blob", gated)
    return gate


def test_files_are_save_epochs_byte_for_byte(tmp_path):
    state = _state()
    rec = {"epoch": 3, "step": 7}
    table = torch.rand(16, 12).numpy()
    want = ckpt_io.save_epoch(str(tmp_path / "sync"), state, 3, True, rec,
                              table)
    ck = ckpt_io.AsyncCheckpointer()
    got = ck.save_epoch(str(tmp_path / "async"), state, 3, True, rec, table)
    ck.wait()
    assert [os.path.basename(p) for p in got] == ["latest.pth", "3.pth"]
    for a, b in zip(got, want):
        assert _bytes(a) == _bytes(b), a
    assert set(ck.write_s) == {3} and ck.write_s[3] > 0
    # write False takes the copy (a sharded state's gather) and writes
    # nothing
    assert ck.save_epoch(str(tmp_path / "none"), state, 4, True,
                         write=False) == []
    ck.wait()
    assert not (tmp_path / "none").exists()


def test_a_pending_save_keeps_the_state_it_was_given(tmp_path, slow_writes):
    """An in-place update of the parameters and Adam's moments after save
    returns does not reach the file being written."""
    state = _state()
    want = ckpt_io.save_epoch(str(tmp_path / "sync"), state, 0, False)[0]
    ck = ckpt_io.AsyncCheckpointer()
    got = ck.save_epoch(str(tmp_path / "async"), state, 0, False)[0]
    _update_in_place(state)
    slow_writes.set()
    ck.wait()
    assert _bytes(got) == _bytes(want)


def test_saves_stay_in_order_behind_a_slow_disk(tmp_path, slow_writes):
    """Three epochs saved while the disk is slow: the third save waits for
    the first write (two copies at most wait), latest.pth ends at the
    newest epoch, and each epoch's file holds its own state."""
    state = _state()
    ck = ckpt_io.AsyncCheckpointer()
    mdir = str(tmp_path / "m")
    live = []
    for e in range(2):
        live.append({k: v.clone() for k, v in
                     state.model.state_dict().items()})
        ck.save_epoch(mdir, state, e, True)
        _update_in_place(state)
    live.append({k: v.clone() for k, v in state.model.state_dict().items()})
    assert len(ck._pending) == 2
    done = threading.Event()

    def third():
        ck.save_epoch(mdir, state, 2, True)
        done.set()

    t = threading.Thread(target=third)
    t.start()
    time.sleep(0.2)
    assert not done.is_set()  # blocked on the oldest pending write
    slow_writes.set()
    t.join(30)
    assert done.is_set()
    ck.wait()
    blobs = {e: torch.load(os.path.join(mdir, f"{e}.pth"),
                           weights_only=True) for e in range(3)}
    latest = torch.load(os.path.join(mdir, "latest.pth"), weights_only=True)
    assert latest["epoch"] == 2
    assert _bytes(os.path.join(mdir, "latest.pth")) == _bytes(
        os.path.join(mdir, "2.pth"))
    for e in range(3):
        assert blobs[e]["epoch"] == e
        assert all(torch.equal(blobs[e]["net"][k], v)
                   for k, v in live[e].items())
    # the three states differ: each file was copied at its own save
    assert not all(torch.equal(blobs[0]["net"][k], v)
                   for k, v in live[2].items())


def test_a_write_error_is_raised_at_the_next_save_or_wait(tmp_path,
                                                         monkeypatch):
    state = _state()

    def broken(path, data):
        raise OSError(f"disk full writing {path}")

    monkeypatch.setattr(ckpt_io, "_atomic_write", broken)
    ck = ckpt_io.AsyncCheckpointer()
    ck.save_epoch(str(tmp_path), state, 0, False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.save_epoch(str(tmp_path), state, 1, False)
    while not ck._pending[0].done():
        time.sleep(0.01)
    with pytest.raises(OSError, match="disk full"):
        ck.save_epoch(str(tmp_path), state, 2, False)
    monkeypatch.undo()
    ck.wait()  # the failed writes were raised once each
