"""Reference-wire-format compatibility: parse/emit monolith protobuf bytes.

The reference's datasets carry three protobuf payload formats
(idl/matrix/proto/proto_parser.proto:21 `Instance`,
idl/matrix/proto/example.proto:138 `Example` / :113 `ExampleBatch`,
parsed by data/parsers.py:242,357,449). Existing monolith datasets and
Kafka topics are serialized in these formats, so a drop-in rebuild must
ingest them directly. This module is a hand-rolled protobuf wire-format
codec (varint walk — no protobuf dependency) that maps those payloads into
this framework's `Example` dataclass and back.

Schema constants (field numbers / wire types) mirror the reference .proto
files — they ARE the compatibility surface:
  Instance:      fid=1 packed fixed64 (fid v1), value=2, label=3,
                 instance_weight=4, line_id=5, feature=9
                 (proto_parser.proto:21-42)
  matrix Feature: name=1, fid=2 packed fixed64 (v2), float_value=3,
                 int64_value=4, bytes_value=5, fid_list=6
                 (feature.proto:21-44)
  Example:       named_feature=1{id=3,name=1,feature=2}, line_id=100,
                 label=101, instance_weight=102 (example.proto:138-146)
  io Feature:    fid_v1_list=1, fid_v2_list=2, float_list=3, int64_list=5,
                 bytes_list=6, fid_v2_lists=7, fid_v1_lists=16
                 (example.proto:61-81)
  ExampleBatch:  named_feature_list=1{id=4,name=1,feature=2,type=3},
                 batch_size=3 (example.proto:96-113)
  LineId:        uid=2 fixed64, req_time=3, item_id=4 fixed64, actions=6
                 packed int32, chnid=19, sample_rate=27 float, user_id=49,
                 data_source_name=235 (line_id.proto:9-23)

Special ExampleBatch column names follow the reference's Example->Instance
bridge (data/training_instance/cc/data_reader.cc AddFeature): `__LINE_ID__`
(bytes: serialized LineId), `__LABEL__` (floats), `instance_weight`.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from monolith_tpu_torch.data.example import Example, LineId, slot_of_fid_v1

# wire types
_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5


# ---------------------------------------------------------------------------
# wire-level reader
# ---------------------------------------------------------------------------

def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _fields(data: bytes):
    """Yield (field_number, wire_type, value); value is int for varint,
    raw little-endian int for fixed64/32, bytes for length-delimited.
    Unknown fields are the caller's job to ignore (just don't match them)."""
    pos, n = 0, len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if wt == _VARINT:
            v, pos = _read_varint(data, pos)
        elif wt == _FIXED64:
            v = int.from_bytes(data[pos:pos + 8], "little")
            pos += 8
        elif wt == _LEN:
            ln, pos = _read_varint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
        elif wt == _FIXED32:
            v = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        yield field, wt, v


def _zigzag_i64(v: int) -> int:
    """Interpret a varint as two's-complement int64 (proto int32/int64)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits & 0xFFFFFFFF))[0]


# packed repeated decoders (handle both packed blobs and lone values)

def _fixed64s(wt: int, v, out: List[int]) -> None:
    if wt == _LEN:
        out.extend(np.frombuffer(v, dtype="<u8").tolist())
    else:
        out.append(int(v))


def _floats(wt: int, v, out: List[float]) -> None:
    if wt == _LEN:
        out.extend(np.frombuffer(v, dtype="<f4").tolist())
    else:
        out.append(_f32(v))


def _varints(wt: int, v, out: List[int]) -> None:
    if wt == _LEN:
        pos = 0
        while pos < len(v):
            x, pos = _read_varint(v, pos)
            out.append(_zigzag_i64(x))
    else:
        out.append(_zigzag_i64(v))


# ---------------------------------------------------------------------------
# message parsers
# ---------------------------------------------------------------------------

def parse_line_id(data: bytes) -> LineId:
    """idl.matrix.proto.LineId (line_id.proto:9)."""
    li = LineId()
    actions: List[int] = []
    for f, wt, v in _fields(data):
        if f == 2:
            li.uid = int(v)
        elif f == 3:
            li.req_time = _zigzag_i64(v)
        elif f == 4:
            li.item_id = int(v)
        elif f == 6:
            _varints(wt, v, actions)
        elif f == 19:
            li.chnid = _zigzag_i64(v)
        elif f == 27:
            li.sample_rate = _f32(v)
        elif f == 49:
            li.user_id = v.decode("utf-8", "replace")
        elif f == 235:
            li.data_source_name = v.decode("utf-8", "replace")
    li.actions = actions
    return li


def _parse_matrix_feature(data: bytes):
    """idl.matrix.proto.Feature (feature.proto:21): named feature column
    inside an Instance. Returns (name, fids, floats, int64s)."""
    name = ""
    fids: List[int] = []
    floats: List[float] = []
    int64s: List[int] = []
    for f, wt, v in _fields(data):
        if f == 1:
            name = v.decode("utf-8", "replace")
        elif f == 2:
            _fixed64s(wt, v, fids)
        elif f == 3:
            _floats(wt, v, floats)
        elif f == 4:
            _varints(wt, v, int64s)
        elif f == 6:  # repeated Fixed64List fid_list (sequence) — flatten
            for ff, fwt, fv in _fields(v):
                if ff == 1:
                    _fixed64s(fwt, fv, fids)
    return name, fids, floats, int64s


def _parse_io_feature(data: bytes):
    """monolith.io.proto.Feature (example.proto:61): the oneof payload of a
    NamedFeature(List). Returns (fids, floats, int64s, bytes_list)."""
    fids: List[int] = []
    floats: List[float] = []
    int64s: List[int] = []
    blobs: List[bytes] = []

    def fid_list(blob, out):
        for ff, fwt, fv in _fields(blob):
            if ff == 1:
                _fixed64s(fwt, fv, out)

    for f, wt, v in _fields(data):
        if f in (1, 2):  # fid_v1_list / fid_v2_list: FidList
            fid_list(v, fids)
        elif f == 3:  # FloatList
            for ff, fwt, fv in _fields(v):
                if ff == 1:
                    _floats(fwt, fv, floats)
        elif f == 5:  # Int64List
            for ff, fwt, fv in _fields(v):
                if ff == 1:
                    _varints(fwt, fv, int64s)
        elif f == 6:  # BytesList
            for ff, fwt, fv in _fields(v):
                if ff == 1:
                    blobs.append(fv)
        elif f in (7, 16):  # FidLists (sequence of FidList) — flatten
            for ff, fwt, fv in _fields(v):
                if ff == 1:
                    fid_list(fv, fids)
    return fids, floats, int64s, blobs


def parse_instance(data: bytes,
                   fidv1_features: Optional[Sequence[int]] = None,
                   fidv1_feature_names: Optional[Sequence[str]] = None
                   ) -> Example:
    """parser.proto Instance -> Example (ref parse_instances,
    data/parsers.py:242). Top-level v1 fids are grouped by their 10-bit
    slot (fid.h:22); `fidv1_features`/`fidv1_feature_names` select and name
    the slots like the reference parser, default = every present slot as
    "slot_<n>". Named feature columns (field 9) keep their own names."""
    fids: List[int] = []
    values: List[float] = []
    labels: List[float] = []
    weight = 1.0
    line_id = LineId()
    features: Dict[str, np.ndarray] = {}
    dense: Dict[str, np.ndarray] = {}
    for f, wt, v in _fields(data):
        if f == 1:
            _fixed64s(wt, v, fids)
        elif f == 2:
            _floats(wt, v, values)
        elif f == 3:
            _floats(wt, v, labels)
        elif f == 4:
            weight = _f32(v)
        elif f == 5:
            line_id = parse_line_id(v)
        elif f == 9:
            name, ffids, ffloats, fints = _parse_matrix_feature(v)
            if ffids:
                features[name] = np.asarray(ffids, np.uint64).astype(np.int64)
            elif ffloats:
                dense[name] = np.asarray(ffloats, np.float32)
            elif fints:
                dense[name] = np.asarray(fints, np.int64).astype(np.float32)
    if fids:
        arr = np.asarray(fids, np.uint64).astype(np.int64)
        slots = (arr >> np.int64(54)) & np.int64(0x3FF)
        if fidv1_features is None:
            for s in np.unique(slots):
                features[f"slot_{int(s)}"] = arr[slots == s]
        else:
            names = (list(fidv1_feature_names) if fidv1_feature_names
                     else [f"slot_{s}" for s in fidv1_features])
            for s, nm in zip(fidv1_features, names):
                sel = arr[slots == s]
                if len(sel):
                    features[nm] = sel
    if values:
        dense.setdefault("value", np.asarray(values, np.float32))
    return Example(features=features, dense=dense,
                   labels=np.asarray(labels or [0.0], np.float32),
                   instance_weight=weight, line_id=line_id)


def parse_example(data: bytes) -> Example:
    """monolith.io.proto.Example -> Example (ref parse_examples,
    data/parsers.py:357)."""
    features: Dict[str, np.ndarray] = {}
    dense: Dict[str, np.ndarray] = {}
    labels: List[float] = []
    weight = 1.0
    line_id = LineId()
    for f, wt, v in _fields(data):
        if f == 1:  # NamedFeature: name=1, feature=2
            name, payload = "", b""
            for nf, nwt, nv in _fields(v):
                if nf == 1:
                    name = nv.decode("utf-8", "replace")
                elif nf == 2:
                    payload = nv
            fids, floats, int64s, _ = _parse_io_feature(payload)
            if fids:
                features[name] = np.asarray(fids, np.uint64).astype(np.int64)
            elif floats:
                dense[name] = np.asarray(floats, np.float32)
            elif int64s:
                dense[name] = np.asarray(int64s, np.int64).astype(np.float32)
        elif f == 100:
            line_id = parse_line_id(v)
        elif f == 101:
            _floats(wt, v, labels)
        elif f == 102:
            weight = _f32(v)
    return Example(features=features, dense=dense,
                   labels=np.asarray(labels or [0.0], np.float32),
                   instance_weight=weight, line_id=line_id)


def parse_example_batch(data: bytes) -> List[Example]:
    """monolith.io.proto.ExampleBatch (column-major) -> row Examples (ref
    parse_example_batch, data/parsers.py:449). SHARED columns broadcast
    their single value to every row; the `__LINE_ID__` / `__LABEL__` /
    `instance_weight` columns map to Example metadata like the reference's
    ExampleToInstance bridge (data_reader.cc AddFeature)."""
    batch_size = 0
    columns = []  # (name, type, [feature payloads])
    for f, wt, v in _fields(data):
        if f == 1:  # NamedFeatureList: name=1, feature=2 repeated, type=3
            name, ftype, payloads = "", 0, []
            for nf, nwt, nv in _fields(v):
                if nf == 1:
                    name = nv.decode("utf-8", "replace")
                elif nf == 2:
                    payloads.append(nv)
                elif nf == 3:
                    ftype = nv
            columns.append((name, ftype, payloads))
        elif f == 3:
            batch_size = v
    if batch_size == 0:
        for name, ftype, payloads in columns:
            if ftype == 0:  # INDIVIDUAL
                batch_size = max(batch_size, len(payloads))
    out = [Example(features={}, dense={}) for _ in range(batch_size)]
    for name, ftype, payloads in columns:
        for i in range(batch_size):
            # a SHARED column may legally carry zero payloads (feature
            # absent for the whole batch) — guard instead of indexing
            payload = (payloads[0] if payloads else b"") if ftype == 1 else (
                payloads[i] if i < len(payloads) else b"")
            if not payload:
                continue
            fids, floats, int64s, blobs = _parse_io_feature(payload)
            ex = out[i]
            if name == "__LINE_ID__":
                if blobs:
                    ex.line_id = parse_line_id(blobs[0])
            elif name == "__LABEL__":
                if floats:
                    ex.labels = np.asarray(floats, np.float32)
            elif name == "instance_weight":
                if floats:
                    ex.instance_weight = float(floats[0])
            elif fids:
                ex.features[name] = np.asarray(fids,
                                               np.uint64).astype(np.int64)
            elif floats:
                ex.dense[name] = np.asarray(floats, np.float32)
            elif int64s:
                ex.dense[name] = np.asarray(int64s,
                                            np.int64).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# encoders (interop the other way: feed a reference consumer, build fixtures)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _LEN) + _varint(len(payload)) + payload


def _packed_fixed64(field: int, vals) -> bytes:
    if len(vals) == 0:
        return b""
    return _len_field(field,
                      np.asarray(vals, np.int64).astype("<u8").tobytes())


def _packed_float(field: int, vals) -> bytes:
    if len(vals) == 0:
        return b""
    return _len_field(field, np.asarray(vals, "<f4").tobytes())


def _packed_varint(field: int, vals) -> bytes:
    if len(vals) == 0:
        return b""
    return _len_field(field, b"".join(_varint(int(v)) for v in vals))


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, _FIXED32) + struct.pack("<f", v)


def encode_line_id(li: LineId) -> bytes:
    out = bytearray()
    if li.uid:
        out += _tag(2, _FIXED64) + struct.pack("<Q", li.uid & (1 << 64) - 1)
    if li.req_time:
        out += _tag(3, _VARINT) + _varint(li.req_time)
    if li.item_id:
        out += _tag(4, _FIXED64) + struct.pack("<Q",
                                               li.item_id & (1 << 64) - 1)
    if len(li.actions):
        out += _packed_varint(6, li.actions)
    if li.chnid:
        out += _tag(19, _VARINT) + _varint(li.chnid)
    if li.sample_rate != 1.0:
        out += _float_field(27, li.sample_rate)
    if li.user_id:
        out += _len_field(49, li.user_id.encode())
    if li.data_source_name:
        out += _len_field(235, li.data_source_name.encode())
    return bytes(out)


def encode_instance(ex: Example) -> bytes:
    """Example -> parser.proto Instance bytes. Features whose fids carry a
    v1 slot prefix go to the top-level packed `fid` field; others are
    emitted as named matrix Feature columns (field 9)."""
    out = bytearray()
    v1_fids: List[int] = []
    named: List[Tuple[str, np.ndarray]] = []
    for name, fids in ex.features.items():
        arr = np.asarray(fids, np.int64)
        if name.startswith("slot_") and name[5:].isdigit() and len(arr) and \
                (slot_of_fid_v1(int(arr[0]) & (1 << 64) - 1) ==
                 int(name[5:])):
            v1_fids.extend(arr.tolist())
        else:
            named.append((name, arr))
    out += _packed_fixed64(1, v1_fids)
    if "value" in ex.dense:
        out += _packed_float(2, ex.dense["value"])
    out += _packed_float(3, ex.labels)
    out += _float_field(4, ex.instance_weight)
    lid = encode_line_id(ex.line_id)
    if lid:
        out += _len_field(5, lid)
    for name, arr in named:
        feat = _len_field(1, name.encode()) + _packed_fixed64(2, arr)
        out += _len_field(9, feat)
    for name, vals in ex.dense.items():
        if name == "value":
            continue
        feat = _len_field(1, name.encode()) + _packed_float(3, vals)
        out += _len_field(9, feat)
    return bytes(out)


def _encode_io_feature_fids(fids, v1: bool = False) -> bytes:
    inner = _packed_fixed64(1, fids)
    return _len_field(1 if v1 else 2, inner)


def encode_example(ex: Example) -> bytes:
    """Example -> monolith.io.proto.Example bytes."""
    out = bytearray()
    for name, fids in ex.features.items():
        payload = _encode_io_feature_fids(np.asarray(fids, np.int64))
        nf = _len_field(1, name.encode()) + _len_field(2, payload)
        out += _len_field(1, nf)
    for name, vals in ex.dense.items():
        payload = _len_field(3, _packed_float(1, vals))  # FloatList
        nf = _len_field(1, name.encode()) + _len_field(2, payload)
        out += _len_field(1, nf)
    lid = encode_line_id(ex.line_id)
    if lid:
        out += _len_field(100, lid)
    out += _packed_float(101, ex.labels)
    out += _float_field(102, ex.instance_weight)
    return bytes(out)


def encode_example_batch(examples: Sequence[Example]) -> bytes:
    """Examples -> monolith.io.proto.ExampleBatch (column-major) bytes."""
    names: List[str] = []
    for ex in examples:
        for n in list(ex.features) + list(ex.dense):
            if n not in names:
                names.append(n)
    out = bytearray()
    for name in names:
        col = bytearray()
        col += _len_field(1, name.encode())
        for ex in examples:
            if name in ex.features:
                payload = _encode_io_feature_fids(
                    np.asarray(ex.features[name], np.int64))
            elif name in ex.dense:
                payload = _len_field(3, _packed_float(1, ex.dense[name]))
            else:
                payload = b""
            col += _len_field(2, payload)
        out += _len_field(1, bytes(col))
    # __LABEL__ / __LINE_ID__ / instance_weight columns
    lab = bytearray(_len_field(1, b"__LABEL__"))
    for ex in examples:
        lab += _len_field(2, _len_field(3, _packed_float(1, ex.labels)))
    out += _len_field(1, bytes(lab))
    lid_col = bytearray(_len_field(1, b"__LINE_ID__"))
    for ex in examples:
        blob = _len_field(6, _len_field(1, encode_line_id(ex.line_id)))
        lid_col += _len_field(2, blob)
    out += _len_field(1, bytes(lid_col))
    iw = bytearray(_len_field(1, b"instance_weight"))
    for ex in examples:
        iw += _len_field(2, _len_field(3, _packed_float(
            1, [ex.instance_weight])))
    out += _len_field(1, bytes(iw))
    out += _tag(3, _VARINT) + _varint(len(examples))
    return bytes(out)
