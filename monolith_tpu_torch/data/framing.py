"""Length-prefixed record framing (the port's copy of the record writer and
reader): each record is [optional sort_id section][8-byte LE size][payload].
The optional headers (has_sort_id, kafka_dump, kafka_dump_prefix) are kept,
so a file framed by the JAX package reads here and the reverse. The warmup
records beside a serving export use this framing.
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
