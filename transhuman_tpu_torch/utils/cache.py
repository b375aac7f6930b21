"""Thread-safe byte-bounded LRU for host-side numpy caches (a copy of
transhuman_tpu/utils/cache.py, which the port may not import).

One implementation for the input path's caches (per-camera ray grids,
processed input views, undistort maps), which loader threads share.

Values are numpy arrays or tuples containing arrays/None.  Stored arrays are
marked read-only: every cache here hands out shared views that concurrent
Loader threads must not mutate (callers copy, e.g. np.stack / explicit
.copy(), before writing).
"""

from __future__ import annotations

from collections import OrderedDict
from threading import Lock

import numpy as np


def _nbytes(value) -> int:
    if value is None:
        return 0
    if isinstance(value, np.ndarray):
        return value.nbytes
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(v) for v in value)
    return 0


def _freeze(value):
    if isinstance(value, np.ndarray):
        value.setflags(write=False)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _freeze(v)


class ByteLRU:
    """get/put cache evicting least-recently-used entries past `max_bytes`.

    The byte bound (not a count bound) is deliberate: one 1024x1024 ray grid
    or undistort map is MBs, and a count bound silently held gigabytes.  At
    least one entry is always kept so an oversized single value still
    caches.  get/put each take the internal lock; computing a missed value
    outside the lock (two threads may both compute, last put wins) is the
    intended usage — values are deterministic functions of their keys.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._d: "OrderedDict" = OrderedDict()
        self._lock = Lock()
        # running byte total maintained on insert/evict/overwrite: put() is
        # O(evictions), not O(entries) — Loader worker threads serialize on
        # this lock and a full rescan per insert was O(n) with multi-MB values
        self._total = 0

    def get(self, key):
        with self._lock:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
            return hit

    def put(self, key, value):
        if value is None:
            # get() signals a miss with None, so a stored bare None would
            # look like a permanent miss and be recomputed forever; store
            # an 'absent' marker inside a tuple instead (zju's undistort
            # cache stores (None, None), for example)
            raise ValueError(
                "ByteLRU cannot store bare None (indistinguishable from a "
                "miss); wrap the marker in a tuple"
            )
        _freeze(value)
        nb = _nbytes(value)
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._total -= _nbytes(old)
            self._d[key] = value
            self._total += nb
            while self._total > self.max_bytes and len(self._d) > 1:
                _, v = self._d.popitem(last=False)  # oldest first
                self._total -= _nbytes(v)
        return value

    def clear(self):
        with self._lock:
            self._d.clear()
            self._total = 0

    def __len__(self):
        with self._lock:
            return len(self._d)
