"""Prefetching loader (counterpart of transhuman_tpu/data/loader.py): host
work on the next items (eval rays, ~0.15-0.19 s per 512x512 frame; train
samples) runs in worker threads while the card works on the current one.
Items come out in the order of the index list whatever order they finish
in.  ``num_workers`` 0 fetches each item inline, in the consumer's thread.

The workers build host data only: a consumer copies an item to the card on
its own thread, so no worker thread touches the card's stream.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

WORKERS, PREFETCH = 2, 2


class Loader:
    def __init__(self, fetch: Callable[[int], object],
                 indices: Sequence[int], num_workers: int = WORKERS):
        """num_workers + PREFETCH items are in flight."""
        self.fetch = fetch
        self.indices = list(indices)
        self.num_workers = max(0, num_workers)

    def __len__(self):
        return len(self.indices)

    def __iter__(self) -> Iterator:
        if self.num_workers == 0:
            for i in self.indices:
                yield self.fetch(i)
            return
        pool = ThreadPoolExecutor(self.num_workers)
        try:
            it = iter(self.indices)
            pending = [pool.submit(self.fetch, i) for _, i in
                       zip(range(self.num_workers + PREFETCH), it)]
            while pending:
                fut = pending.pop(0)
                for i in it:
                    pending.append(pool.submit(self.fetch, i))
                    break
                yield fut.result()
        finally:
            # a consumer that stops early leaves no queued fetch running
            pool.shutdown(wait=False, cancel_futures=True)
