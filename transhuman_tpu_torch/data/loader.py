"""Prefetching loader (counterpart of transhuman_tpu/data/loader.py): host
work on the next items (eval rays, ~0.15-0.19 s per 512x512 frame) runs in
two worker threads while the card renders the current one.  Items come out
in the order of the index list whatever order they finish in."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

WORKERS, PREFETCH = 2, 2


class Loader:
    def __init__(self, fetch: Callable[[int], object],
                 indices: Sequence[int]):
        """WORKERS + PREFETCH items are in flight."""
        self.fetch = fetch
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __iter__(self) -> Iterator:
        pool = ThreadPoolExecutor(WORKERS)
        try:
            it = iter(self.indices)
            pending = [pool.submit(self.fetch, i) for _, i in
                       zip(range(WORKERS + PREFETCH), it)]
            while pending:
                fut = pending.pop(0)
                for i in it:
                    pending.append(pool.submit(self.fetch, i))
                    break
                yield fut.result()
        finally:
            # a consumer that stops early leaves no queued fetch running
            pool.shutdown(wait=False, cancel_futures=True)
