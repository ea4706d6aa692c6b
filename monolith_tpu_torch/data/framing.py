"""Length-prefixed record framing (the port's copy of the record writer and
reader): each record is [optional sort_id section][8-byte LE size][payload].
The optional headers (has_sort_id, kafka_dump, kafka_dump_prefix) are kept,
so a file framed by the JAX package reads here and the reverse. The warmup
records beside a serving export use this framing.

`write_example_file` / `read_example_file` / `read_example_records` carry
`Example` payloads in any of `payload_decoder`'s formats (the native "mtex"
codec and the reference's protobuf formats, `pb_compat`).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, Optional


class RecordWriter:
    def __init__(self, f: BinaryIO, has_sort_id: bool = False):
        self._f = f
        self.has_sort_id = has_sort_id

    def write(self, payload: bytes, sort_id: bytes = b"") -> None:
        if self.has_sort_id:
            self._f.write(struct.pack("<Q", len(sort_id)))
            self._f.write(sort_id)
        self._f.write(struct.pack("<Q", len(payload)))
        self._f.write(payload)

    def flush(self):
        self._f.flush()


class RecordReader:
    """Iterates (sort_id, payload) records; truncated tails are dropped."""

    def __init__(self, f: BinaryIO, has_sort_id: bool = False,
                 kafka_dump: bool = False, kafka_dump_prefix: bool = False):
        self._f = f
        self.has_sort_id = has_sort_id
        self.kafka_dump = kafka_dump
        self.kafka_dump_prefix = kafka_dump_prefix

    def _read_exact(self, n: int) -> Optional[bytes]:
        b = self._f.read(n)
        return b if len(b) == n else None

    def __iter__(self) -> Iterator:
        # kafka_dump_prefix: stream starts with an extra size+dump-flag pair
        if self.kafka_dump_prefix:
            hdr = self._read_exact(8)
            if hdr is None:
                return
            (aggregate_size,) = struct.unpack("<Q", hdr)
            if aggregate_size > 0:
                pass  # aggregated page size; records follow normally
        while True:
            sort_id = b""
            if self.kafka_dump:
                hdr = self._read_exact(8)
                if hdr is None:
                    return
            if self.has_sort_id:
                hdr = self._read_exact(8)
                if hdr is None:
                    return
                (n,) = struct.unpack("<Q", hdr)
                sort_id = self._read_exact(n)
                if sort_id is None:
                    return
            hdr = self._read_exact(8)
            if hdr is None:
                return
            (n,) = struct.unpack("<Q", hdr)
            payload = self._read_exact(n)
            if payload is None:
                return
            yield sort_id, payload


def write_example_file(path: str, examples, has_sort_id: bool = False) -> int:
    """Write Examples to a framed file; returns record count."""
    n = 0
    with open(path, "wb") as f:
        w = RecordWriter(f, has_sort_id=has_sort_id)
        for ex in examples:
            w.write(ex.to_bytes())
            n += 1
    return n


def payload_decoder(fmt: str = "mtex"):
    """Record-payload decoder: bytes -> list[Example].

    Formats: "mtex" (this framework's native codec), and the reference's
    protobuf wire formats "pb_instance" / "pb_example" / "pb_example_batch"
    (idl/matrix/proto; see data/pb_compat.py) so existing monolith datasets
    and Kafka topics stream straight in."""
    from monolith_tpu_torch.data.example import Example
    if fmt == "mtex":
        return lambda b: [Example.from_bytes(b)]
    from monolith_tpu_torch.data import pb_compat
    if fmt == "pb_instance":
        return lambda b: [pb_compat.parse_instance(b)]
    if fmt == "pb_example":
        return lambda b: [pb_compat.parse_example(b)]
    if fmt == "pb_example_batch":
        return pb_compat.parse_example_batch
    raise ValueError(f"unknown payload format {fmt!r}")


def read_example_file(path: str, has_sort_id: bool = False,
                      fmt: str = "mtex"):
    """Yield Examples from a framed file (see payload_decoder for formats)."""
    decode = payload_decoder(fmt)
    with open(path, "rb") as f:
        for _, payload in RecordReader(f, has_sort_id=has_sort_id):
            yield from decode(payload)


def read_example_records(path: str, has_sort_id: bool = False,
                         fmt: str = "mtex", skip_records: int = 0,
                         skip_examples: int = 0):
    """Yield (record_idx, example_idx_in_record, Example) from a framed file.

    Records before `skip_records` are frame-skipped — their payload bytes
    are never DECODED (for pb_example_batch the protobuf parse dominates
    read cost, so resume cost is O(bytes) sequential IO, not O(examples)
    parse). Within the first yielded record, the first `skip_examples`
    examples are dropped — resuming mid-batch after an ExampleBatch
    checkpoint lands exactly on the next unseen example."""
    decode = payload_decoder(fmt)
    with open(path, "rb") as f:
        for ri, (_, payload) in enumerate(
                RecordReader(f, has_sort_id=has_sort_id)):
            if ri < skip_records:
                continue
            exs = decode(payload)
            start = skip_examples if ri == skip_records else 0
            for ei in range(start, len(exs)):
                yield ri, ei, exs[ei]
