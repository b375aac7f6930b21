"""A lock between processes on one file system, and an atomic small-file
write: the kernel and host-library builds take them, so that ranks
started together on a fresh checkout build each library once and never
read a half-written stamp."""

from __future__ import annotations

import contextlib
import fcntl
import os


@contextlib.contextmanager
def file_lock(path: str):
    """An exclusive ``flock`` on ``path`` (created if missing) for the
    length of the block; another process, or another thread with its own
    open of the file, waits for it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def write_atomic(path: str, text: str):
    """Write ``text`` to a process-unique file beside ``path``, then
    replace ``path`` with it: a reader sees the old content or the new."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
