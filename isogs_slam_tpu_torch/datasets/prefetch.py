"""Background frame prefetcher for sequential dataset access (counterpart
of isogs_slam_tpu/datasets/prefetch.py).

`Prefetcher` wraps any indexable dataset and keeps a lookahead window
loaded by a daemon thread, so `get(i)` for the sequential SLAM loop is a
dictionary hit while frames i+1.. load in parallel with tracking/mapping.
Random access (eval loops) falls through to the dataset. With the synthetic
dataset the worker thread renders on the card, on the pipeline's stream.
"""
from __future__ import annotations

import collections
import threading


class Prefetcher:
    """Lookahead cache over `dataset[i]` for mostly-sequential access."""

    def __init__(self, dataset, depth: int = 4):
        self.dataset = dataset
        self.depth = max(1, depth)
        self._cache: dict = {}
        self._order: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._want = 0            # next index the consumer will ask for
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        # transparent proxy for dataset attributes (cam, intrinsics, ...)
        return getattr(self.dataset, name)

    def _worker(self):
        while True:
            with self._cv:
                while not self._stop:
                    target = None
                    for i in range(self._want, min(self._want + self.depth,
                                                   len(self.dataset))):
                        if i not in self._cache:
                            target = i
                            break
                    if target is not None:
                        break
                    self._cv.wait()
                if self._stop:
                    return
            item = self.dataset[target]
            with self._cv:
                self._insert(target, item)
                self._cv.notify_all()

    def _insert(self, i, item):
        if i not in self._cache:
            self._cache[i] = item
            self._order.append(i)
            while len(self._order) > 2 * self.depth + 2:
                old = self._order.popleft()
                self._cache.pop(old, None)

    def get(self, i: int):
        with self._cv:
            self._want = i + 1
            self._cv.notify_all()
            if i in self._cache:
                return self._cache[i]
        # miss: load synchronously (random access / first frame)
        item = self.dataset[i]
        with self._cv:
            self._insert(i, item)
            self._cv.notify_all()
        return item

    def __getitem__(self, i: int):
        return self.get(i)

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=2.0)
