"""Threaded prefetching batch loader.

Port of ``nerfdet_tpu/data/loader.py``: worker threads run the numpy
pipeline (its large operations release the GIL) and batches are
prefetched ahead of the training step, so the host's work overlaps the
card's. The threads, the prefetch capacity, the worker-death error and
the shuffle order from ``seed`` are the original's; a batch is the list
of its numpy scenes (``api.train_batch`` takes such a list) instead of
their stacked arrays. With one worker the scenes come in exactly the
original's order and with its random draws.

Data parallel over ``world`` processes, every rank shuffles the same
global order from ``seed``; global batch i is ``order[i W B:(i + 1) W
B]`` and rank r takes its ``[r B:(r + 1) B]``. Where the dataset draws
each scene's seed from a shared stream (``skip_seeds``), a rank steps
the stream past the other ranks' scenes of each global batch, so with
one worker a rank the ranks see the scenes and the draws one process
sees at batch W B.

One fault of the original is repaired: a worker that raises records its
batch and error, and the consumer raises (from that error) when it
reaches that batch. The original notices only when every thread has
ended, so with several workers it waits for ever once the others fill
the prefetch capacity and block (ROADMAP §3).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


class BatchLoader:
    """Iterate batches of ``batch_size`` scenes with prefetch.

    Args:
        dataset: indexable dataset returning per-scene dicts.
        batch_size: scenes per batch.
        shuffle: reshuffle scene order each epoch.
        num_workers: pipeline threads.
        prefetch: max batches queued ahead.
        drop_last: drop the ragged tail batch.
        seed: shuffle seed.
        rank, world: this process's share of each global batch of
            ``world * batch_size`` scenes (``drop_last`` only).
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True, seed: int = 0, rank: int = 0,
                 world: int = 1):
        if world > 1 and not drop_last:
            raise ValueError("a ragged global batch does not split over "
                             "the ranks: drop_last")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rank, self.world = rank, world
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        """Global batches an epoch."""
        n, b = len(self.dataset), self.batch_size * self.world
        return n // b if self.drop_last else (n + b - 1) // b

    def __iter__(self) -> Iterator[List[Dict[str, np.ndarray]]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        n_batches = len(self)
        size = self.batch_size * self.world
        start = self.rank * self.batch_size
        batches = [
            order[i * size + start:i * size + start + self.batch_size]
            for i in range(n_batches)
        ]
        skip = getattr(self.dataset, "skip_seeds", None)
        before = start if skip is not None else 0
        after = size - start - self.batch_size if skip is not None else 0

        idx_q: "queue.Queue" = queue.Queue()
        for bi, idxs in enumerate(batches):
            idx_q.put((bi, idxs))
        results: Dict[int, List] = {}
        errors: Dict[int, BaseException] = {}
        cond = threading.Condition()
        stop = threading.Event()
        # capacity invariant: prefetch completed-but-unconsumed batches
        # plus one insertion slot per in-flight worker, so the worker
        # holding the batch the consumer needs can always insert it
        capacity = self.prefetch + self.num_workers

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    if before:
                        skip(before)
                    batch = [self.dataset[int(i)] for i in idxs]
                    if after:
                        skip(after)
                except BaseException as e:
                    with cond:
                        errors[bi] = e
                        cond.notify_all()
                    raise
                with cond:
                    while not stop.is_set() and len(results) >= capacity:
                        cond.wait(timeout=1.0)
                    if stop.is_set():
                        return
                    results[bi] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            for bi in range(n_batches):
                with cond:
                    while bi not in results:
                        if bi in errors or not any(t.is_alive()
                                                   for t in threads):
                            raise RuntimeError(
                                "loader workers died before producing "
                                f"batch {bi}") from errors.get(bi)
                        # timeout so worker death is noticed even if no
                        # notify ever arrives
                        cond.wait(timeout=0.5)
                    batch = results.pop(bi)
                    cond.notify_all()
                yield batch
        finally:
            stop.set()
            with cond:
                cond.notify_all()
