"""A small msgpack codec for the files flax writes (standard library and numpy only).

`flax.serialization.msgpack_serialize` / `msgpack_restore` store a tree of
str-keyed maps whose leaves are Python scalars, strings, bytes, lists and
numpy arrays. An array is msgpack extension type 1 whose payload is itself
msgpack: the array `(shape, dtype name, C-order bytes)`; a numpy scalar is
type 3 with the same payload; arrays over 2**30 bytes are split into a map
`{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`.
`packb` writes what flax reads and `unpackb` reads what flax writes; an
extension type other than 1 and 3, or a dtype name numpy does not know
(flax's `bfloat16`), raises.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


# --- encoding ---------------------------------------------------------------------------


def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0 <= n <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, n))
    elif 0 <= n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, n))
    elif 0 <= n <= 0xFFFF_FFFF:
        out.append(struct.pack(">BI", 0xCE, n))
    elif 0 <= n <= 0xFFFF_FFFF_FFFF_FFFF:
        out.append(struct.pack(">BQ", 0xCF, n))
    elif -0x80 <= n:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif -0x8000 <= n:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif -0x8000_0000 <= n:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif -0x8000_0000_0000_0000 <= n:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"integer {n} does not fit in 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: list) -> None:
    """A length header: the fix form when it fits, else 8/16/32-bit (codes may omit 8)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, top in zip(codes, (">BB", ">BH", ">BI")[-len(codes):],
                              (0xFF, 0xFFFF, 0xFFFF_FFFF)[-len(codes):]):
        if n <= top:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"object of length {n} is too long for msgpack")


def _pack_bin(b: bytes, out: list) -> None:
    _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _pack_ext(code: int, payload: bytes, out: list) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    else:
        _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
        out.append(struct.pack(">b", code))
    out.append(payload)


def _array_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.names is not None:
        raise ValueError(f"cannot serialise an array of dtype {a.dtype}")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _chunked(a: np.ndarray) -> dict:
    per = max(1, MAX_CHUNK_BYTES // a.dtype.itemsize)
    flat = a.reshape(-1)
    chunks = [flat[i:i + per] for i in range(0, flat.size, per)]
    return {_CHUNKED: True, "shape": {str(i): n for i, n in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_BYTES:
            _pack(_chunked(obj), out)
        else:
            _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(bytes(obj), out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__} to msgpack")


def packb(obj) -> bytes:
    """msgpack bytes of `obj` in flax's layout."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# --- decoding ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}


def _dtype(name) -> np.dtype:
    """numpy's own dtype of that name (not one an extension registers, such as
    bfloat16, which torch cannot take from numpy)."""
    name = bytes(name).decode() if isinstance(name, (bytes, memoryview)) else name
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt is None or dt.isbuiltin != 1:
        raise ValueError(f"array of dtype {name!r}, which numpy does not know")
    return dt


def _array(payload: memoryview) -> np.ndarray:
    shape, dtype, buf = _decode(_Reader(payload), raw=True)
    return np.frombuffer(bytes(buf), dtype=_dtype(dtype)).reshape(shape)


def _ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _array(payload)
    if code == EXT_NPSCALAR:
        return _array(payload)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


def _decode(r: _Reader, raw: bool = False):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _decode_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _STR:
        return _str(r.take(r.unpack(_LEN[_STR[b]])), raw)
    if b in _BIN:
        return bytes(r.take(r.unpack(_LEN[_BIN[b]])))
    if b in _ARRAY:
        return [_decode(r, raw) for _ in range(r.unpack(_LEN[_ARRAY[b]]))]
    if b in _MAP:
        return _decode_map(r, r.unpack(_LEN[_MAP[b]]), raw)
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b in _EXT:
        n = r.unpack(_LEN[_EXT[b]])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _str(b: memoryview, raw: bool):
    return bytes(b) if raw else str(b, "utf-8")


def _decode_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r, raw)
        out[k] = _decode(r, raw)
    return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """The tree that flax's `msgpack_restore` would give for `data`."""
    r = _Reader(data)
    tree = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)
