"""Batches for validation (counterpart of `lpc_yolo_tpu/data/build.py`: `collate`
and the one-pass `DataLoader`).

Samples are made by a pool of worker threads, in dataset order. The last
batch is padded to `batch_size` by repeating its final sample, as the JAX
loader does; `pad_count` tells the consumer how many rows to drop. The frames
stay a list, because their shapes differ: the card letterboxes them.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


def collate(samples) -> Dict:
    out = {"img": [s["img"] for s in samples]}
    for k in ("cls", "bboxes", "mask"):
        out[k] = np.stack([s[k] for s in samples])
    for k in ("orig_shape", "gain", "pad", "path"):
        out[k] = [s[k] for s in samples]
    return out


class DataLoader:
    """One pass over `dataset` through `transforms(dataset, i)`, in order, `batch_size` samples a batch."""

    def __init__(self, dataset, transforms, batch_size: int = 16, workers: int = 4):
        self.dataset = dataset
        self.transforms = transforms
        self.batch_size = batch_size
        self.workers = max(workers, 1)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        B = self.batch_size
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            for start in range(0, len(self.dataset), B):
                chunk = list(range(start, min(start + B, len(self.dataset))))
                pad_count = B - len(chunk)
                chunk += [chunk[-1]] * pad_count
                batch = collate(list(pool.map(lambda i: self.transforms(self.dataset, i), chunk)))
                batch["pad_count"] = pad_count
                yield batch
