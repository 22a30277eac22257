"""The subset of MessagePack that flax's `serialization.to_bytes` writes, both ways.

`to_bytes(tree)` encodes a tree of dicts with str keys, lists, str, bytes,
int, float, bool, None, numpy arrays and numpy scalars to the bytes that
`flax.serialization.to_bytes` gives for the same tree (msgpack's smallest
header for every int, str, bin, array, map and ext), so a file written here
is a flax file. A numpy array is ext type 1 around
`packb((shape, dtype.name, bytes))`, a numpy scalar ext type 3 around the
same payload of its 0-d array (flax's `_ndarray_to_bytes`); a Python float
is a float64. Dict keys keep their insertion order: a JAX pytree's dicts
come in sorted key order, and the bridge builds its trees so.

`from_bytes(blob)` decodes such bytes into the same kinds of values, with
arrays as writable numpy arrays. Flax splits a leaf of more than 2**30 bytes
into chunks; this codec refuses such a leaf both ways.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

MAX_LEAF_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE: larger array leaves are chunked by flax, refused here
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


def _uint_header(n: int, fix: int, fix_max: int, codes: Tuple[int, int, int]) -> bytes:
    """A length header: the fix form below fix_max, else the 8/16/32-bit form (codes[0] may be -1: none)."""
    if n < fix_max:
        return bytes([fix | n])
    if codes[0] >= 0 and n <= 0xFF:
        return bytes([codes[0], n])
    if n <= 0xFFFF:
        return struct.pack(">BH", codes[1], n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", codes[2], n)
    raise ValueError(f"msgpack object of {n} elements or bytes is too large")


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, hi in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF), (0xCE, ">BI", 0xFFFFFFFF),
                              (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
            if n <= hi:
                return struct.pack(fmt, code, n)
    else:
        for code, fmt, lo in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000), (0xD2, ">Bi", -0x80000000),
                              (0xD3, ">Bq", -0x8000000000000000)):
            if n >= lo:
                return struct.pack(fmt, code, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _bin(b: bytes) -> bytes:
    return _uint_header(len(b), 0, 0, (0xC4, 0xC5, 0xC6)) + b


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    elif n <= 0xFF:
        head = bytes([0xC7, n])
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack(">b", code) + payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.names:
        raise ValueError(f"arrays of dtype {arr.dtype} cannot be serialized")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"an array leaf of {arr.nbytes} bytes is over {MAX_LEAF_BYTES}: flax would split it "
                         f"into chunks, which this codec does not write")
    out: List[bytes] = []
    _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], out)
    return b"".join(out)


def _pack(x: Any, out: List[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _ndarray_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(x))))
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        b = x.encode("utf-8")
        out.append(_uint_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b)
    elif type(x) in (bytes, bytearray):
        out.append(_bin(bytes(x)))
    elif type(x) is dict:
        out.append(_uint_header(len(x), 0x80, 16, (-1, 0xDE, 0xDF)))
        for k, v in x.items():
            if type(k) is not str:
                raise TypeError(f"map keys must be str, got {k!r}")
            _pack(k, out)
            _pack(v, out)
    elif type(x) in (list, tuple):
        out.append(_uint_header(len(x), 0x90, 16, (-1, 0xDC, 0xDD)))
        for v in x:
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def to_bytes(tree: Any) -> bytes:
    """A tree -> the bytes `flax.serialization.to_bytes` writes for it."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self, raw: bool = False) -> Any:
        c = self.unpack(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F, raw)
        if 0x90 <= c <= 0x9F:
            return [self.read(raw) for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self._str(c & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in sized:
            return bytes(self.take(self.unpack(sized[c])))
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in nums:
            return self.unpack(nums[c])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in strs:
            return self._str(self.unpack(strs[c]), raw)
        if c in (0xDC, 0xDD):
            return [self.read(raw) for _ in range(self.unpack(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if c == 0xDE else ">I"), raw)
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixed:
            return self._ext(fixed[c])
        if c in (0xC7, 0xC8, 0xC9):
            return self._ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c]))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not supported")

    def _str(self, n: int, raw: bool):
        b = bytes(self.take(n))
        return b if raw else b.decode("utf-8")

    def _map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.read(raw)
            out[k] = self.read(raw)
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax wrote a chunked array (a leaf over 2**30 bytes); this codec does not read it")
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        sub = _Reader(payload)
        shape, dtype, buf = sub.read(raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]


def from_bytes(blob: bytes) -> Any:
    """Bytes that flax's `to_bytes` (or `to_bytes` here) wrote -> the tree, arrays as numpy arrays."""
    r = _Reader(blob)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return out
