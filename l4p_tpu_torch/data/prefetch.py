"""Background-thread batch prefetcher (counterpart of
l4p_tpu/data/prefetch.py).

A ThreadPoolExecutor with a bounded number of items in flight decodes and
preprocesses ahead of the card (the native library, l4p_tpu_torch.native,
runs in these threads without holding the interpreter lock). Results come
back in index order, a worker's exception reaches the consumer, and close()
cancels what is queued.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator


class PrefetchIterator:
    """Wrap `make_item(i)` in a thread pool with at most `buffer` items in
    flight, yielding results in order."""

    def __init__(self, make_item: Callable[[int], Dict], length: int,
                 num_threads: int = 2, buffer: int = 4):
        self.make_item = make_item
        self.length = length
        self.buffer = max(1, buffer)
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_threads))
        self._closed = False

    def __iter__(self) -> Iterator[Dict]:
        futures = {}
        next_submit = 0
        try:
            while next_submit < min(self.buffer, self.length):
                futures[next_submit] = self._pool.submit(self.make_item, next_submit)
                next_submit += 1
            for i in range(self.length):
                if self._closed:
                    break
                item = futures.pop(i).result()  # propagates worker exceptions
                if next_submit < self.length:
                    futures[next_submit] = self._pool.submit(self.make_item, next_submit)
                    next_submit += 1
                yield item
        finally:
            for f in futures.values():
                f.cancel()
            self.close()

    def close(self):
        if not self._closed:
            self._closed = True
            self._pool.shutdown(wait=False, cancel_futures=True)


def prefetch_dataset(dataset, num_threads: int = 2, buffer: int = 4, collate_fn=None):
    """Iterate a dataset with background preprocessing."""
    from l4p_tpu_torch.data.dataset import collate

    cf = collate_fn or collate
    return PrefetchIterator(lambda i: cf(dataset[i]), len(dataset), num_threads, buffer)
