"""Text embeddings for YOLO-World's `set_classes` (counterpart of `lpc_yolo_tpu/utils/text_embed.py`).

The reference encodes class names with CLIP ViT-B/32. With no CLIP weights in
the repository, `encode_names` takes real text features through
`embeddings=`, or gives each name a deterministic unit vector seeded by its
SHA-256: a stand-in that drives the whole open-vocabulary path (the
text-guided attention and the contrastive logits) with reproducible numbers,
not a semantic text encoder. The numbers are the JAX package's, bit for bit.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np

EMBED_DIM = 512


def encode_names(names: Sequence[str], dim: int = EMBED_DIM, embeddings: Optional[np.ndarray] = None) -> np.ndarray:
    """(M, dim) f32 rows, one per class name, each divided by max(its L2 norm, 1e-12).

    embeddings: (M, dim) text features (e.g. CLIP's) to use instead; their shape is checked. Otherwise each
    name's row is `RandomState(seed).randn(dim)` with the seed the first four bytes of its SHA-256,
    little-endian.
    """
    if embeddings is not None:
        e = np.asarray(embeddings, np.float32)
        if e.shape != (len(names), dim):
            raise ValueError(f"embeddings shape {e.shape} != ({len(names)}, {dim})")
    else:
        rows = []
        for n in names:
            seed = int.from_bytes(hashlib.sha256(n.encode()).digest()[:4], "little")
            rows.append(np.random.RandomState(seed).randn(dim).astype(np.float32))
        e = np.stack(rows)
    return e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
