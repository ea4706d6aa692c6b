"""The msgpack state-dict format of dense checkpoints, read and written
with `struct` and numpy alone.

The JAX package writes `dense.msgpack` and `opt_state.msgpack` with
`flax.serialization.to_bytes`; the port must read and write the same bytes
without importing flax or msgpack. This module implements the subset of
msgpack that such a file holds:

- nested maps with `str` keys (written in sorted key order at every level,
  the order a JAX tree of dicts has once it has passed through a tree map;
  a `Fields` map in its own order, the order of a NamedTuple's fields,
  which flax writes for an optax state such as Adamom's (m, v, c));
- ext type 1, an ndarray, whose payload is itself the msgpack array
  `(shape, dtype name, bytes)`; ext type 3, a numpy scalar, the same payload;
- ints, floats, bools and nil.

Integers, strings, maps and arrays take the shortest encoding, as the
msgpack package's packer chooses them, so `to_bytes` of a tree equals
flax's bytes for it. The chunked form flax uses for a leaf above 2^30 bytes
(`__msgpack_chunked_array__`) is refused with an error in both directions:
no dense parameter is that large.

`from_bytes(template, data)` is structural like flax's: the decoded tree
must have exactly the template's keys, and (stricter than flax) every array
the template's shape; otherwise it raises.

`save_model_state` / `load_model_state` write and read the
`model_state.msgpack` of a checkpoint or an export: a module's buffers as
flax's `{"batch_stats": ...}`, written only for a module that has any.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np

from monolith_tpu_torch import convert

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_LEAF_BYTES = 2 ** 30   # flax chunks a leaf above this size


# ----------------------------------------------------------------------
# writer
# ----------------------------------------------------------------------

def _pack_int(n: int) -> bytes:
    if n >= 0:
        if n < 0x80:
            return struct.pack("B", n)
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        if n >= -32:
            return struct.pack("b", n)
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)), (0xd3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        head = bytes([0xa0 | n])
    elif n < 1 << 8:
        head = bytes([0xd9, n])
    elif n < 1 << 16:
        head = b"\xda" + struct.pack(">H", n)
    else:
        head = b"\xdb" + struct.pack(">I", n)
    return head + b


def _pack_bin(b: bytes) -> bytes:
    n = len(b)
    if n < 1 << 8:
        head = bytes([0xc4, n])
    elif n < 1 << 16:
        head = b"\xc5" + struct.pack(">H", n)
    else:
        head = b"\xc6" + struct.pack(">I", n)
    return head + b


def _pack_array_head(n: int) -> bytes:
    if n < 16:
        return bytes([0x90 | n])
    if n < 1 << 16:
        return b"\xdc" + struct.pack(">H", n)
    return b"\xdd" + struct.pack(">I", n)


def _pack_map_head(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n < 1 << 16:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    elif n < 1 << 8:
        head = bytes([0xc7, n])
    elif n < 1 << 16:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack("b", code) + payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured arrays are not serialized")
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(
            f"an array of {arr.nbytes} bytes needs the chunked form "
            f"({_CHUNKED}), which the port does not write")
    return (_pack_array_head(3)
            + _pack_array_head(arr.ndim)
            + b"".join(_pack_int(int(d)) for d in arr.shape)
            + _pack_str(arr.dtype.name) + _pack_bin(arr.tobytes("C")))


class Fields(dict):
    """A map written in its insertion order, as flax writes the fields of a
    NamedTuple; every other map is written in sorted key order."""


def _pack(x: Any) -> bytes:
    if isinstance(x, dict):
        out = [_pack_map_head(len(x))]
        for k in (x if isinstance(x, Fields) else sorted(x)):
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str (got {k!r})")
            out += [_pack_str(k), _pack(x[k])]
        return b"".join(out)
    if isinstance(x, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _ndarray_payload(x))
    if isinstance(x, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    if x is None:
        return b"\xc0"
    if isinstance(x, bool):
        return b"\xc3" if x else b"\xc2"
    if isinstance(x, int):
        return _pack_int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, str):
        return _pack_str(x)
    raise TypeError(f"cannot serialize {type(x).__name__}")


def to_bytes(tree: Dict) -> bytes:
    """Serialize a nested dict of numpy arrays (and ints, floats, bools,
    None, numpy scalars) as flax.serialization.to_bytes does."""
    return _pack(tree)


# ----------------------------------------------------------------------
# reader
# ----------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.num("B")
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode("utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.num({0xc4: ">B", 0xc5: ">H",
                                             0xc6: ">I"}[b])))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.num({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
            return self.ext(n)
        if b == 0xca:
            return self.num(">f")
        if b == 0xcb:
            return self.num(">d")
        if 0xcc <= b <= 0xd3:
            return self.num({0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                             0xd0: ">b", 0xd1: ">h", 0xd2: ">i",
                             0xd3: ">q"}[b])
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            n = self.num({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b])
            return bytes(self.take(n)).decode("utf-8")
        if b in (0xdc, 0xdd):
            return [self.read()
                    for _ in range(self.num(">H" if b == 0xdc else ">I"))]
        if b in (0xde, 0xdf):
            return self.map(self.num(">H" if b == 0xde else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, str):
                raise ValueError(f"map keys must be str (got {k!r})")
            out[k] = self.read()
        if _CHUNKED in out:
            raise ValueError(
                f"the file holds a chunked array ({_CHUNKED}: a leaf above "
                f"2^30 bytes), which the port does not read")
        return out

    def ext(self, n: int) -> Any:
        code = self.num("b")
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = _Reader(payload).read()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes) -> Any:
    """Decode serialized bytes into nested dicts with numpy leaves (arrays
    are read-only views of `data`)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes follow the "
                         f"msgpack object")
    return out


def _restore_into(template: Any, state: Any, path: str) -> Any:
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError(f"{path or '/'}: expected a map, found "
                             f"{type(state).__name__}")
        if set(template) != set(state):
            raise ValueError(
                f"{path or '/'}: keys differ: the file has "
                f"{sorted(state)}, the target {sorted(template)}")
        return {k: _restore_into(template[k], state[k], f"{path}/{k}")
                for k in template}
    if isinstance(template, np.ndarray):
        if not isinstance(state, np.ndarray):
            raise ValueError(f"{path}: expected an array, found "
                             f"{type(state).__name__}")
        if state.shape != template.shape:
            raise ValueError(f"{path}: shape {state.shape} in the file != "
                             f"{template.shape} in the target")
    return state


def from_bytes(template: Dict, data: bytes) -> Dict:
    """Decode `data` into a tree with exactly the template's keys (and, for
    array leaves, the template's shapes); raises on any difference."""
    return _restore_into(template, msgpack_restore(data), "")


def save_model_state(directory: str, tree: Dict) -> None:
    """Write `model_state.msgpack` for a model with non-parameter state (a
    `convert.model_state_tree`), as the JAX package writes it only then."""
    if tree:
        with open(os.path.join(directory, "model_state.msgpack"), "wb") as f:
            f.write(to_bytes(tree))


def load_model_state(directory: str, module) -> None:
    """Read `model_state.msgpack` from a checkpoint or an export into the
    module's buffers, when both exist (a module without such state ignores
    the file, as the JAX package does; a module with it keeps its initial
    statistics when the file is missing)."""
    path = os.path.join(directory, "model_state.msgpack")
    template = convert.model_state_tree(module)
    if template and os.path.exists(path):
        with open(path, "rb") as f:
            convert.load_model_state(module, from_bytes(template, f.read()))
