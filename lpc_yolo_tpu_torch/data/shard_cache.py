"""A window of prepared batches served with background refresh (counterpart of
`lpc_yolo_tpu/data/shard_cache.py::AugmentedCache`; the trainer's `cache_augmented`).

The JAX package augments on the host, and a host that cannot augment as fast as the chip trains
starves it; the cache answers by serving the chip from a RAM window of ready batches that one
background thread keeps replacing at whatever rate the host sustains, so each batch is reused
about (chip rate / host rate) times before it is replaced: bounded-staleness batch echoing (Choi
et al., "Faster Neural Network Training with Data Echoing", 2019). `echo_factor()` reports the reuse.

Here a window entry is the loader's host batch: the samples' plans, their source frames and their
labels; the trainer renders each served batch on the card as it renders a fresh one. The window
reshuffles every pass (`RandomState(seed)`), and `invalidate()` refills it synchronously (the trainer
calls it at the close_mosaic boundary, where the plans change). `stop()` ends the refresh thread and
closes the loader's iterator, which stops its worker threads.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional

import numpy as np


class AugmentedCache:
    """Serve train batches from a refreshing RAM window over a real loader.

    Args:
        loader: an infinite DataLoader of plans (data/build.py); the cache
            consumes its iterator from one place only.
        capacity: number of batches held; RAM = capacity * (the batch's source
            frames, shared with the dataset's image cache when it has one).
        refresh: keep a daemon thread replacing entries round-robin at host
            speed. Off = a frozen window (tests / reproducibility).
        seed: window shuffle seed.
    """

    def __init__(self, loader, capacity: int = 16, refresh: bool = True, seed: int = 0):
        self.loader = loader
        self.capacity = max(int(capacity), 1)
        self.seed = seed
        self._src = iter(loader)
        self._src_lock = threading.Lock()  # the source iterator is not thread-safe
        self._slot_lock = threading.Lock()
        self._stop = threading.Event()
        self.served = 0
        self.refreshed = 0
        self._slots = [self._produce() for _ in range(self.capacity)]
        self._thread: Optional[threading.Thread] = None
        if refresh:
            self._thread = threading.Thread(
                target=self._refresh_loop, name="aug-cache-refresh", daemon=True
            )
            self._thread.start()

    def _produce(self) -> Dict[str, np.ndarray]:
        with self._src_lock:
            return next(self._src)

    def _refresh_loop(self) -> None:
        i = 0
        while not self._stop.is_set():
            try:
                batch = self._produce()
            except StopIteration:  # finite loader drained: freeze the window
                return
            with self._slot_lock:
                self._slots[i % self.capacity] = batch
            self.refreshed += 1
            i += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        while True:
            order = rng.permutation(self.capacity)
            for j in order:
                with self._slot_lock:
                    batch = self._slots[j]
                self.served += 1
                yield batch

    def invalidate(self) -> None:
        """Synchronously refill every slot (augmentation semantics changed,
        e.g. the close_mosaic boundary — reference trainer.py:354-356)."""
        for i in range(self.capacity):
            batch = self._produce()
            with self._slot_lock:
                self._slots[i] = batch
        self.refreshed += self.capacity

    def echo_factor(self) -> float:
        """Average number of times each served batch was reused (1.0 = every
        batch fresh; ~chip_rate/host_rate when the chip outruns the host)."""
        return self.served / max(self.capacity + self.refreshed, 1)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        with self._src_lock:
            close = getattr(self._src, "close", None)
            if close is not None:
                close()

    def __len__(self) -> int:
        return len(self.loader)
