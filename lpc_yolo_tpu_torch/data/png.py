"""A PNG reader without OpenCV: `read_png(path)` gives what `cv2.imread(path)` (IMREAD_COLOR) gives.

The machine with the card has no OpenCV, so `engine/predictor.py::load_source`
and `data/dataset.py::imread` read `.png` files here before any cv2 import.
Scope: bit depths 8 and 16; grey, grey + alpha, RGB and RGBA; not interlaced;
the five row filters (none, sub, up, average, paeth); the image data inflated
by the standard library's `zlib`. The output is cv2's: HWC uint8 BGR, grey
spread to three channels, alpha dropped, 16-bit samples cut to their high
byte (libpng's `png_set_strip_16`). Ancillary chunks (gamma, colour profile,
transparency, EXIF) are ignored, as cv2 ignores them for a colour read. A
palette, a depth under 8 or an interlaced file raises `NotImplementedError`.
`read_image` reads any image file as cv2.imread does: a PNG here, the rest
(those PNGs too) with cv2, imported only for them. Held to `cv2.imread` bit
for bit in `tests/test_torch_results.py`.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

from ..utils import require_cv2

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of `h` rows of `stride` bytes (each after its filter byte), `bpp` bytes a pixel."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f, cur = int(kinds[y]), data[y]
        if f == 0:
            line = cur.copy()
        elif f == 1:  # sub: a running sum along each byte lane of the pixel, mod 256
            line = np.cumsum(cur.reshape(-1, bpp), 0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # up
            line = cur + prior
        elif f in (3, 4):
            line = _unfilter_serial(f, cur.tolist(), prior.tolist(), bpp)
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type {f}")
        out[y] = line
        prior = out[y]
    return out


def _unfilter_serial(f: int, cur: list, prior: list, bpp: int) -> np.ndarray:
    """The average (3) and paeth (4) filters, whose bytes depend on the decoded byte to their left."""
    line = [0] * len(cur)
    for i, v in enumerate(cur):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if f == 3:
            line[i] = (v + ((a + b) >> 1)) & 255
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (v + pred) & 255
    return np.asarray(line, np.uint8)


def decode_png(blob: bytes) -> np.ndarray:
    """The HWC uint8 BGR array of a PNG file's bytes (see the module's docstring for the scope)."""
    if not blob.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos, ihdr, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(blob):
        n, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise NotImplementedError(f"PNG colour type {ctype}, bit depth {depth}, interlace {interlace}: "
                                  "the reader takes 8- and 16-bit grey, grey + alpha, RGB and RGBA, not interlaced")
    ch, nbytes = _CHANNELS[ctype], depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch * nbytes, ch * nbytes).reshape(h, w, ch, nbytes)
    px = px[..., 0]  # a 16-bit sample is big-endian: its high byte first
    colour = np.repeat(px[..., :1], 3, -1) if ch <= 2 else px[..., 2::-1]
    return np.ascontiguousarray(colour)


def read_png(path: Union[str, Path]) -> np.ndarray:
    """`cv2.imread(path)` of a PNG file, without OpenCV: HWC uint8 BGR."""
    return decode_png(Path(path).read_bytes())


def read_image(path: Union[str, Path]) -> np.ndarray:
    """`cv2.imread(path)` of any image file: a PNG through `read_png` without OpenCV, any other format (or
    a PNG outside `read_png`'s scope) through cv2; an ImportError that names the file when cv2 is missing,
    FileNotFoundError when cv2 cannot read it."""
    if Path(path).suffix.lower() == ".png":
        try:
            return read_png(path)
        except NotImplementedError:
            pass
    im = require_cv2(f"reading the image {path}").imread(str(path))
    if im is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return im
