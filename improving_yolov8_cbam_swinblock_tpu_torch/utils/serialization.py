"""Reader and writer of flax's msgpack checkpoint format, in Python and numpy.

The JAX package writes its `.ckpt` files with
`flax.serialization.msgpack_serialize` and reads them with
`msgpack_restore`; this port may import neither flax nor msgpack, so this
module is its own counterpart of the two:

  * the msgpack types: maps, arrays, str, bin, ints, floats, bool, nil;
  * ext 1, an ndarray: its payload is a msgpack array (shape, dtype name,
    C-order bytes). `bfloat16`, which numpy lacks, is read as its raw
    uint16 bits and returned as a torch.bfloat16 tensor, and a
    torch.bfloat16 tensor is written under that name;
  * ext 3, a numpy scalar: the same payload with shape ();
  * ext 2 (a native complex) and a leaf flax split into chunks (a map with
    `__msgpack_chunked_array__`, leaves over 2**30 bytes) raise.

`dumps` writes what flax writes for the same tree: the map keys of each
level sorted (as jax's tree_map leaves them before flax packs), ints and
lengths in their smallest msgpack form, floats as doubles, str as str and
bytes as bin. Tuples are written as arrays and read back as lists.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
# msgpack type bytes: the constants, the fixed-width numbers (struct formats),
# the types whose length follows (bin, ext, str, array, map) and the fixext sizes
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class FormatError(ValueError):
    """Bytes that are not a checkpoint this reader takes."""


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str payloads as bytes (the ndarray payload's dtype name)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise FormatError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        if t in _SIMPLE:
            return _SIMPLE[t]
        if t in _NUMBERS:
            return self.unpack(_NUMBERS[t])
        if t in _LENGTHS:
            n = self.unpack(_LENGTHS[t])
            if t <= 0xC6:
                return bytes(self.take(n))
            if t <= 0xC9:
                return self.ext(self.unpack(">b"), n)
            if t <= 0xDB:
                return self.str_(n)
            return self.array(n) if t <= 0xDD else self.map_(n)
        if t in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[t])
        raise FormatError(f"msgpack type byte 0x{t:02x} at offset {self.pos - 1} is not used by flax checkpoints")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if CHUNKED in out:
            raise FormatError("a leaf over 2**30 bytes, chunked by flax (__msgpack_chunked_array__), is not read "
                              "by the port: no model this repo builds has one")
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray_from_payload(payload)
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            raise FormatError("msgpack ext type 2 (a native complex number) is not read by the port")
        raise FormatError(f"unknown msgpack ext type {code}")


def _ndarray_from_payload(payload: bytes):
    shape, name, buf = _Reader(payload, raw=True).obj()
    shape = tuple(int(s) for s in shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").reshape(shape)
        return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def loads(data: bytes) -> Any:
    """The tree that flax.serialization.msgpack_restore returns for `data`:
    dicts, lists and scalars, numpy arrays (read-only views of the bytes)
    and numpy scalars; bfloat16 leaves as torch.bfloat16 tensors."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise FormatError(f"{len(r.data) - r.pos} bytes after the end of the msgpack object")
    return out


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _head(n: int, fix: Tuple[int, int], forms) -> bytes:
    """A length header: the fix form (base, limit) when n fits, else the
    first of `forms` ((type byte, struct format, limit), ...) that holds n."""
    base, limit = fix
    if base is not None and n < limit:
        return bytes([base | n])
    for tb, fmt, lim in forms:
        if n < lim:
            return bytes([tb]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} elements or bytes is too large")


def _int(v: int) -> bytes:
    if -32 <= v < 0x80:  # positive and negative fixint
        return bytes([v & 0xFF])
    if v >= 0:
        for tb, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                             (0xCF, ">Q", 1 << 64)):
            if v < lim:
                return bytes([tb]) + struct.pack(fmt, v)
    for tb, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
        if v >= -lim:
            return bytes([tb]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack's 64 bits")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _head(len(b), (0xA0, 32), ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))) + b


def _bin(b: bytes) -> bytes:
    return _head(len(b), (None, 0), ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))) + b


def _ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        head = bytes([fixext[len(payload)]])
    else:
        head = _head(len(payload), (None, 0), ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32)))
    return head + struct.pack(">b", code) + payload


def _ndarray_payload(shape, name: str, buf: bytes) -> bytes:
    return b"".join([_array_head(3), _array_head(len(shape)), *(_int(int(s)) for s in shape), _str(name), _bin(buf)])


def _array_head(n: int) -> bytes:
    return _head(n, (0x90, 16), ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is bytes:
        out.append(_bin(obj))
    elif isinstance(obj, dict):
        out.append(_head(len(obj), (0x80, 16), ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))))
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        out.append(_array_head(len(obj)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            buf = t.view(torch.int16).numpy().astype("<u2").tobytes()
            out.append(_ext(EXT_NDARRAY, _ndarray_payload(t.shape, "bfloat16", buf)))
        else:
            _pack(t.numpy(), out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.fields is not None:
            raise ValueError(f"object and structured dtypes are not written: {obj.dtype}")
        out.append(_ext(EXT_NDARRAY, _ndarray_payload(obj.shape, obj.dtype.name, obj.tobytes("C"))))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        out.append(_ext(EXT_NPSCALAR, _ndarray_payload(arr.shape, arr.dtype.name, arr.tobytes("C"))))
    else:
        raise TypeError(f"cannot write {type(obj).__name__} into a flax msgpack checkpoint")


def dumps(tree: Any) -> bytes:
    """Bytes that flax.serialization.msgpack_restore reads back to `tree`
    (tuples as lists). Leaves: None, bool, int, float, str, bytes, numpy
    arrays and scalars, torch tensors (bfloat16 included)."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)
