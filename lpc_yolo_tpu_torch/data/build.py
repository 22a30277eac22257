"""Batches and the seeded loader (counterpart of `lpc_yolo_tpu/data/build.py`: `collate`
and `DataLoader`, :19-105).

Samples are made by a pool of worker threads (file reads, transforms or
plans). Each sample draws from its own `np.random.RandomState((seed + epoch)
* 100003 + index)`, so the number and order of workers cannot change a batch.
With `shuffle` the order of an epoch is `RandomState(seed + epoch)`'s
permutation; `infinite` runs epoch after epoch (training), otherwise one
pass (validation). The last batch of an epoch is padded to `batch_size` by
repeating its final sample; `pad_count` tells the consumer how many rows to
drop. Unlike the JAX loader, `shuffle` defaults to False (the validator's
one pass).

Frames whose shapes differ (validation) stay a list: the card letterboxes
them. Training plans (`TrainTransforms.plan`) stay a list of plans with the
batch's source frames, which the trainer renders on the card.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


def collate(samples) -> Dict:
    out: Dict = {}
    if "img" in samples[0]:
        imgs = [s["img"] for s in samples]
        out["img"] = imgs if "orig_shape" in samples[0] else np.stack(imgs)
    if "plan" in samples[0]:
        out["plan"] = [s["plan"] for s in samples]
        out["sources"] = {k: v for s in samples for k, v in s["sources"].items()}
    for k in ("cls", "bboxes", "mask", "masks", "keypoints", "rboxes", "label"):
        if k in samples[0]:
            out[k] = np.stack([s[k] for s in samples])
    for k in ("orig_shape", "gain", "pad", "path"):
        if k in samples[0]:
            out[k] = [s[k] for s in samples]
    return out


class DataLoader:
    """Batches of `transforms(dataset, i, rng)`, `batch_size` samples each."""

    def __init__(self, dataset, transforms, batch_size: int = 16, workers: int = 4, shuffle: bool = False,
                 seed: int = 0, infinite: bool = False):
        self.dataset = dataset
        self.transforms = transforms
        self.batch_size = batch_size
        self.workers = max(workers, 1)
        self.shuffle = shuffle
        self.seed = seed
        self.infinite = infinite
        self.epoch = 0

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict]:
        epoch, B = self.epoch, self.batch_size
        pool = ThreadPoolExecutor(max_workers=self.workers)
        try:
            while True:
                idx = self._indices(epoch)
                for start in range(0, len(idx), B):
                    chunk = [int(i) for i in idx[start:start + B]]
                    pad_count = B - len(chunk)
                    chunk += [chunk[-1]] * pad_count
                    rngs = [np.random.RandomState((self.seed + epoch) * 100003 + i) for i in chunk]
                    batch = collate(list(pool.map(lambda a: self.transforms(self.dataset, a[0], a[1]),
                                                  zip(chunk, rngs))))
                    batch["pad_count"] = pad_count
                    yield batch
                if not self.infinite:
                    return
                epoch += 1
                self.epoch = epoch
        finally:
            pool.shutdown(wait=False)
