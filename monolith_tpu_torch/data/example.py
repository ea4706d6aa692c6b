"""Training example format + binary codec.

The port's copy of the JAX package's data/example.py (numpy only; the
same bytes in both packages): the reference's serving IDL (Example / NamedFeature /
LineId — idl/matrix/proto/example.proto:102-150, line_id.proto:23) without a
protobuf dependency: an `Example` carries named sparse fid lists, named dense
float features, labels, an instance weight, and LineId-style metadata
(uid/item_id/req_time/actions/channel/sample_rate).

The wire format is a self-describing little-endian binary (version byte +
sectioned arrays), written through the framed-file layer (framing.py) that
mirrors the reference's 8-byte length-prefixed record streams
(data/training_instance/cc/data_reader.cc:63).

Fid encoding helpers follow the reference's slot conventions (fid.h:22-31):
  v1: slot = fid >> 54 (10-bit slot)
  v2: slot = (fid >> 48) & 0x7fff (15-bit slot)
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

_MAGIC = b"MTEX"
_VERSION = 1


# --- fid slot encoding (ref data/training_instance/cc/fid.h:22-31) ---

def make_fid_v1(slot: int, signature: int) -> int:
    return (slot << 54) | (signature & ((1 << 54) - 1))


def slot_of_fid_v1(fid: int) -> int:
    return fid >> 54


def make_fid_v2(slot: int, signature: int) -> int:
    return (1 << 63) | (slot << 48) | (signature & ((1 << 48) - 1))


def slot_of_fid_v2(fid: int) -> int:
    return (fid >> 48) & 0x7FFF


@dataclasses.dataclass
class LineId:
    """Per-example metadata (ref line_id.proto:23)."""
    uid: int = 0
    item_id: int = 0
    req_time: int = 0
    sample_rate: float = 1.0
    chnid: int = 0
    actions: Sequence[int] = ()
    user_id: str = ""
    data_source_name: str = ""


@dataclasses.dataclass
class Example:
    """One training example (ref example.proto:138 Example)."""
    features: Dict[str, np.ndarray]          # name -> int64 fids (ragged)
    dense: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    labels: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, np.float32))
    instance_weight: float = 1.0
    line_id: LineId = dataclasses.field(default_factory=LineId)

    # --- codec ---

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        buf.write(_MAGIC)
        buf.write(struct.pack("<B", _VERSION))

        def write_str(s: str):
            b = s.encode("utf-8")
            buf.write(struct.pack("<I", len(b)))
            buf.write(b)

        def write_arr(a: np.ndarray, dtype):
            a = np.ascontiguousarray(a, dtype=dtype)
            buf.write(struct.pack("<I", a.size))
            buf.write(a.tobytes())

        buf.write(struct.pack("<I", len(self.features)))
        for name in sorted(self.features):
            write_str(name)
            write_arr(self.features[name], np.int64)
        buf.write(struct.pack("<I", len(self.dense)))
        for name in sorted(self.dense):
            write_str(name)
            write_arr(self.dense[name], np.float32)
        write_arr(self.labels, np.float32)
        buf.write(struct.pack("<f", self.instance_weight))
        li = self.line_id
        buf.write(struct.pack("<qqqfq", li.uid, li.item_id, li.req_time,
                              li.sample_rate, li.chnid))
        write_arr(np.asarray(li.actions, dtype=np.int32), np.int32)
        write_str(li.user_id)
        write_str(li.data_source_name)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Example":
        buf = io.BytesIO(data)
        magic = buf.read(4)
        if magic != _MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        (version,) = struct.unpack("<B", buf.read(1))
        if version != _VERSION:
            raise ValueError(f"unsupported version {version}")

        def read_str() -> str:
            (n,) = struct.unpack("<I", buf.read(4))
            return buf.read(n).decode("utf-8")

        def read_arr(dtype) -> np.ndarray:
            (n,) = struct.unpack("<I", buf.read(4))
            itemsize = np.dtype(dtype).itemsize
            return np.frombuffer(buf.read(n * itemsize), dtype=dtype).copy()

        (nf,) = struct.unpack("<I", buf.read(4))
        features = {}
        for _ in range(nf):
            name = read_str()
            features[name] = read_arr(np.int64)
        (nd,) = struct.unpack("<I", buf.read(4))
        dense = {}
        for _ in range(nd):
            name = read_str()
            dense[name] = read_arr(np.float32)
        labels = read_arr(np.float32)
        (w,) = struct.unpack("<f", buf.read(4))
        uid, item_id, req_time, sample_rate, chnid = struct.unpack(
            "<qqqfq", buf.read(8 * 4 + 4))
        actions = read_arr(np.int32)
        user_id = read_str()
        dsn = read_str()
        return cls(features=features, dense=dense, labels=labels,
                   instance_weight=w,
                   line_id=LineId(uid=uid, item_id=item_id, req_time=req_time,
                                  sample_rate=sample_rate, chnid=chnid,
                                  actions=actions.tolist(), user_id=user_id,
                                  data_source_name=dsn))


def batch_examples(examples: Sequence[Example],
                   feature_lengths: Dict[str, int],
                   dense_keys: Optional[Sequence[str]] = None):
    """Assemble examples into trainer inputs — the host-side equivalent of
    the reference's parse_instances/parse_examples (data/parsers.py:242,357).

    Returns (fid_batch {name: int64 [B, L] pad -1},
             batch {"label": [B], "instance_weight": [B], dense...}).
    Per-feature fid lists are truncated/padded to feature_lengths[name].
    """
    B = len(examples)
    fid_batch = {}
    for name, L in feature_lengths.items():
        m = np.full((B, L), -1, dtype=np.int64)
        for i, ex in enumerate(examples):
            v = ex.features.get(name)
            if v is not None and len(v):
                k = min(len(v), L)
                m[i, :k] = v[:k]
        fid_batch[name] = m
    batch = {
        "label": np.array([ex.labels[0] if len(ex.labels) else 0.0
                           for ex in examples], dtype=np.float32),
        "instance_weight": np.array([ex.instance_weight for ex in examples],
                                    dtype=np.float32),
    }
    if dense_keys:
        for k in dense_keys:
            batch[k] = np.stack([ex.dense[k] for ex in examples]).astype(np.float32)
    return fid_batch, batch
