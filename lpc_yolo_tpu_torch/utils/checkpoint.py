"""`.ckpt` files, the JAX package's format (counterpart of `lpc_yolo_tpu/utils/checkpoint.py:21-43`).

A file is the 8-byte little-endian length of a JSON meta header, the header
(`json.dumps(meta)`), then the tree as flax msgpack (`utils/msgpack.py`,
byte-equal to `flax.serialization.to_bytes`). It is written to a `.tmp`
beside it and renamed, so a reader never sees half a file. Both packages
read each other's files: the JAX package restores the tree into a template
state (`serialization.from_bytes` needs every key of the template), and
`load_checkpoint` here returns the tree as nested dicts of numpy arrays.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Tuple, Union

from . import msgpack


def read_meta(path: Union[str, Path]) -> Dict[str, Any]:
    """The JSON meta header of a `.ckpt` file, without reading its tree."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(n).decode())


def write_checkpoint(path: Union[str, Path], blob: bytes, meta: Dict[str, Any]) -> None:
    """Write an encoded tree (`msgpack.to_bytes`) and its meta to `path`, atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta_b = json.dumps(meta).encode()
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(len(meta_b).to_bytes(8, "little"))
        f.write(meta_b)
        f.write(blob)
    os.replace(tmp, path)


def save_checkpoint(path: Union[str, Path], tree: Any, meta: Dict[str, Any]) -> None:
    """Serialize a tree of dicts and numpy arrays and a JSON meta dict to `path`, atomically."""
    write_checkpoint(path, msgpack.to_bytes(tree), meta)


def load_checkpoint(path: Union[str, Path]) -> Tuple[Any, Dict[str, Any]]:
    """A `.ckpt` file -> (the tree as nested dicts of numpy arrays, the meta dict)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        blob = f.read()
    return msgpack.from_bytes(blob), meta
