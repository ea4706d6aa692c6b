"""Dataset sources and the batching pipeline.

The port's copy of the JAX package's data/datasets.py: the reference data API (data/datasets.py: PBDataset
:311, FilePBDataset :472, KafkaDataset :1223, ParquetDataset :415, split/merge
flow :868,890). Sources are plain Python iterators of `Example` (the C++
dataset kernels' work — framing, parsing — lives in example.py/framing.py and
the native batcher); `BatchedDataset` assembles trainer-ready
(fid_batch, batch) pairs.

Kafka streaming is pluggable: `KafkaSource` uses confluent_kafka when
present; `QueueSource` is the in-process stand-in used by streaming tests
(the reference tests fake Kafka the same way).
"""

from __future__ import annotations

import glob as glob_lib
import itertools
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from monolith_tpu_torch.data.example import Example, batch_examples
from monolith_tpu_torch.data.framing import read_example_records


class FileSource:
    """Framed example files (ref FilePBDataset data/datasets.py:472).

    Tracks its position so a worker's dataset-iterator state can be
    checkpointed and resumed (ref hooks/ckpt_hooks.py WorkerCkptHelper):
    `state()` returns {"epoch", "file_idx", "record_idx", "example_idx"}
    — record_idx counts framed RECORDS, example_idx the examples consumed
    within the current record (nonzero only for multi-example payloads
    like pb_example_batch). Resume frame-skips whole records without
    decoding their payloads. Legacy states without "example_idx" (where
    record_idx counted examples) still resume via decode-skip."""

    def __init__(self, patterns: Sequence[str], has_sort_id: bool = False,
                 repeat: bool = False, fmt: str = "mtex"):
        """`fmt` selects the record payload codec: "mtex" (native) or the
        reference protobuf formats "pb_instance" / "pb_example" /
        "pb_example_batch" (framing.payload_decoder) — existing monolith
        datasets ingest without conversion."""
        if isinstance(patterns, str):
            patterns = [patterns]
        self.paths: List[str] = []
        for p in patterns:
            self.paths.extend(sorted(glob_lib.glob(p)) or [p])
        self.has_sort_id = has_sort_id
        self.repeat = repeat
        self.fmt = fmt
        self._pos = {"epoch": 0, "file_idx": 0, "record_idx": 0,
                     "example_idx": 0}

    def state(self) -> Dict[str, int]:
        return dict(self._pos)

    def set_state(self, state: Dict[str, int]) -> None:
        self._pos = dict(state)

    def __iter__(self) -> Iterator[Example]:
        epoch = self._pos["epoch"]
        start_file = self._pos["file_idx"]
        legacy_skip = 0
        if "example_idx" in self._pos:
            skip_rec = self._pos["record_idx"]
            skip_ex = self._pos["example_idx"]
        else:  # legacy state: record_idx counted EXAMPLES; decode-skip
            skip_rec = skip_ex = 0
            legacy_skip = self._pos["record_idx"]
        while True:
            for fi in range(start_file, len(self.paths)):
                self._pos.update(file_idx=fi, epoch=epoch)
                for ri, ei, ex in read_example_records(
                        self.paths[fi], has_sort_id=self.has_sort_id,
                        fmt=self.fmt, skip_records=skip_rec,
                        skip_examples=skip_ex):
                    if legacy_skip > 0:
                        legacy_skip -= 1
                        continue
                    # position = examples consumed so far, so a state()
                    # taken after receiving this example resumes at the
                    # next one (possibly mid-record)
                    self._pos["record_idx"] = ri
                    self._pos["example_idx"] = ei + 1
                    yield ex
                skip_rec = skip_ex = legacy_skip = 0
            start_file = 0
            epoch += 1
            self._pos.update(epoch=epoch, file_idx=0, record_idx=0,
                             example_idx=0)
            if not self.repeat:
                return


class ParquetSource:
    """Parquet files -> Examples (ref ParquetDataset data/datasets.py:415).

    fid_columns: {feature_name: column} where the column holds int64 or
    list<int64>; label_column holds float; dense_columns optional.
    """

    def __init__(self, path: str, fid_columns: Dict[str, str],
                 label_column: str, dense_columns: Optional[Dict[str, str]] = None,
                 batch_rows: int = 8192):
        self.path = path
        self.fid_columns = fid_columns
        self.label_column = label_column
        self.dense_columns = dense_columns or {}
        self.batch_rows = batch_rows

    def __iter__(self) -> Iterator[Example]:
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(self.path)
        for rb in pf.iter_batches(batch_size=self.batch_rows):
            cols = {name: rb.column(col).to_pylist()
                    for name, col in self.fid_columns.items()}
            labels = rb.column(self.label_column).to_pylist()
            dense = {name: rb.column(col).to_pylist()
                     for name, col in self.dense_columns.items()}
            for i in range(rb.num_rows):
                feats = {}
                for name in self.fid_columns:
                    v = cols[name][i]
                    if v is None:
                        v = []
                    if not isinstance(v, (list, tuple)):
                        v = [v]
                    feats[name] = np.asarray(v, dtype=np.int64)
                d = {name: np.atleast_1d(np.asarray(dense[name][i], np.float32))
                     for name in dense}
                yield Example(features=feats, dense=d,
                              labels=np.asarray([labels[i]], np.float32))


class QueueSource:
    """In-process streaming source — the test/dev stand-in for Kafka
    (streaming-training loops consume it exactly like KafkaSource)."""

    def __init__(self, maxsize: int = 65536):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._closed = threading.Event()

    def push(self, example: Example) -> None:
        self._q.put(example)

    def close(self) -> None:
        self._closed.set()

    def __iter__(self) -> Iterator[Example]:
        while True:
            try:
                yield self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed.is_set() and self._q.empty():
                    return


class KafkaSource:
    """Kafka consumer of Example payloads (ref KafkaDataset
    data/datasets.py:1223, kernel data/kernels/kafka_kernels.cc).

    `fmt` selects the message payload codec ("mtex" native, or the
    reference protobuf formats "pb_instance"/"pb_example"/
    "pb_example_batch" — existing monolith Kafka topics stream in
    unchanged). `consumer_factory` injects the consumer constructor; the
    default is confluent_kafka.Consumer, tests pass a fake (mirroring the
    reference's mocked-Kafka tests)."""

    def __init__(self, topics: Sequence[str], group_id: str,
                 brokers: str, poll_timeout_s: float = 1.0,
                 stop_on_idle_s: Optional[float] = None, fmt: str = "mtex",
                 consumer_factory=None, **consumer_conf):
        if consumer_factory is None:
            try:
                from confluent_kafka import Consumer
            except ImportError as e:
                raise ImportError(
                    "KafkaSource requires confluent_kafka; use QueueSource "
                    "or FileSource in environments without it, or inject a "
                    "consumer_factory") from e
            consumer_factory = Consumer
        self.consumer_factory = consumer_factory
        self.topics = list(topics)
        self.conf = {"bootstrap.servers": brokers, "group.id": group_id,
                     **consumer_conf}
        self.poll_timeout_s = poll_timeout_s
        self.stop_on_idle_s = stop_on_idle_s
        self.fmt = fmt

    def __iter__(self) -> Iterator[Example]:
        from monolith_tpu_torch.data.framing import payload_decoder
        decode = payload_decoder(self.fmt)
        c = self.consumer_factory(self.conf)
        c.subscribe(self.topics)
        idle = 0.0
        try:
            while True:
                msg = c.poll(self.poll_timeout_s)
                if msg is None or msg.error():
                    idle += self.poll_timeout_s
                    if self.stop_on_idle_s and idle >= self.stop_on_idle_s:
                        return
                    continue
                idle = 0.0
                yield from decode(msg.value())
        finally:
            c.close()


# --- flow control (ref split_flow/merge_flow data/datasets.py:868,890) ---

def split_flow(source: Iterable[Example], num_flows: int,
               flow_fn: Callable[[Example], int]):
    """Split one stream into N by a routing function. Returns N iterators
    backed by per-flow queues filled lazily from the shared source."""
    queues = [list() for _ in range(num_flows)]
    it = iter(source)

    def gen(k):
        while True:
            if queues[k]:
                yield queues[k].pop(0)
                continue
            try:
                ex = next(it)
            except StopIteration:
                return
            queues[flow_fn(ex) % num_flows].append(ex)

    return [gen(k) for k in range(num_flows)]


def merge_flow(sources: Sequence[Iterable[Example]]) -> Iterator[Example]:
    """Round-robin merge of streams, skipping exhausted ones."""
    iters = [iter(s) for s in sources]
    while iters:
        alive = []
        for it in iters:
            try:
                yield next(it)
                alive.append(it)
            except StopIteration:
                pass
        iters = alive


class BatchedDataset:
    """Assemble an Example stream into trainer-ready batches."""

    def __init__(self, source: Iterable[Example], batch_size: int,
                 feature_lengths: Dict[str, int],
                 dense_keys: Optional[Sequence[str]] = None,
                 drop_remainder: bool = True):
        self.source = source
        self.batch_size = batch_size
        self.feature_lengths = feature_lengths
        self.dense_keys = dense_keys
        self.drop_remainder = drop_remainder

    def __iter__(self):
        buf: List[Example] = []
        for ex in self.source:
            buf.append(ex)
            if len(buf) == self.batch_size:
                yield batch_examples(buf, self.feature_lengths, self.dense_keys)
                buf = []
        if buf and not self.drop_remainder:
            yield batch_examples(buf, self.feature_lengths, self.dense_keys)
