"""Binary payload codec for serving messages (the port's copy).

A flat {str: np.ndarray | bytes | str | int | float} dict serializer: the
payload format of predict requests, row pushes and warmup records. Byte for
byte the JAX package's codec (struct + numpy only).
"""

from __future__ import annotations

import io
import struct
from typing import Dict, Union

import numpy as np

Value = Union[np.ndarray, bytes, str, int, float]

_T_ARR, _T_BYTES, _T_STR, _T_INT, _T_FLOAT = 0, 1, 2, 3, 4


def pack(d: Dict[str, Value]) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack("<I", len(d)))
    for k in sorted(d):
        kb = k.encode("utf-8")
        buf.write(struct.pack("<H", len(kb)))
        buf.write(kb)
        v = d[k]
        if isinstance(v, np.ndarray):
            buf.write(struct.pack("<B", _T_ARR))
            dt = np.dtype(v.dtype).str.encode()
            buf.write(struct.pack("<B", len(dt)))
            buf.write(dt)
            buf.write(struct.pack("<B", v.ndim))
            for s in v.shape:
                buf.write(struct.pack("<q", s))
            raw = np.ascontiguousarray(v).tobytes()
            buf.write(struct.pack("<Q", len(raw)))
            buf.write(raw)
        elif isinstance(v, bytes):
            buf.write(struct.pack("<B", _T_BYTES))
            buf.write(struct.pack("<Q", len(v)))
            buf.write(v)
        elif isinstance(v, str):
            vb = v.encode("utf-8")
            buf.write(struct.pack("<B", _T_STR))
            buf.write(struct.pack("<Q", len(vb)))
            buf.write(vb)
        elif isinstance(v, (bool, np.bool_)):
            buf.write(struct.pack("<B", _T_INT))
            buf.write(struct.pack("<q", int(v)))
        elif isinstance(v, (int, np.integer)):
            buf.write(struct.pack("<B", _T_INT))
            buf.write(struct.pack("<q", int(v)))
        elif isinstance(v, (float, np.floating)):
            buf.write(struct.pack("<B", _T_FLOAT))
            buf.write(struct.pack("<d", float(v)))
        else:
            raise TypeError(f"unsupported payload type for {k}: {type(v)}")
    return buf.getvalue()


def unpack(data: bytes) -> Dict[str, Value]:
    buf = io.BytesIO(data)
    (n,) = struct.unpack("<I", buf.read(4))
    out: Dict[str, Value] = {}
    for _ in range(n):
        (kl,) = struct.unpack("<H", buf.read(2))
        k = buf.read(kl).decode("utf-8")
        (t,) = struct.unpack("<B", buf.read(1))
        if t == _T_ARR:
            (dl,) = struct.unpack("<B", buf.read(1))
            dt = np.dtype(buf.read(dl).decode())
            (nd,) = struct.unpack("<B", buf.read(1))
            shape = tuple(struct.unpack("<q", buf.read(8))[0] for _ in range(nd))
            (raw_len,) = struct.unpack("<Q", buf.read(8))
            out[k] = np.frombuffer(buf.read(raw_len), dtype=dt).reshape(shape).copy()
        elif t == _T_BYTES:
            (l,) = struct.unpack("<Q", buf.read(8))
            out[k] = buf.read(l)
        elif t == _T_STR:
            (l,) = struct.unpack("<Q", buf.read(8))
            out[k] = buf.read(l).decode("utf-8")
        elif t == _T_INT:
            out[k] = struct.unpack("<q", buf.read(8))[0]
        elif t == _T_FLOAT:
            out[k] = struct.unpack("<d", buf.read(8))[0]
        else:
            raise ValueError(f"bad type tag {t}")
    return out
