"""Tagged metrics client.

The port's copy of the JAX package's utils/metrics_client.py: ref
runtime/common/metrics.h:25 MetricCollector +
metric/cli.py: counters / rate counters / timers / stores with OpenTSDB-style
tagkv, emitted to pluggable sinks. The open-source reference is a no-op
collector; here the default sink aggregates in-process (queryable, test
friendly) and a file sink appends JSON lines (ref runtime/ops/
file_metric_writer.cc).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

TagKV = Optional[Dict[str, str]]


def _key(name: str, tags: TagKV) -> str:
    if not tags:
        return name
    kv = ",".join(f"{k}={tags[k]}" for k in sorted(tags))
    return f"{name}|{kv}"


class MetricClient:
    def __init__(self, prefix: str = "", sinks: Tuple = ()):
        self.prefix = prefix
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.stores: Dict[str, float] = {}
        self.timers: Dict[str, List[float]] = collections.defaultdict(list)
        self._sinks = list(sinks)

    def _name(self, name: str) -> str:
        return f"{self.prefix}.{name}" if self.prefix else name

    def emit_counter(self, name: str, value: float = 1.0, tags: TagKV = None):
        k = _key(self._name(name), tags)
        with self._lock:
            self.counters[k] += value
        self._emit("counter", k, value)

    def emit_store(self, name: str, value: float, tags: TagKV = None):
        k = _key(self._name(name), tags)
        with self._lock:
            self.stores[k] = value
        self._emit("store", k, value)

    def emit_timer(self, name: str, value_s: float, tags: TagKV = None):
        k = _key(self._name(name), tags)
        with self._lock:
            self.timers[k].append(value_s)
        self._emit("timer", k, value_s)

    class _Timing:
        def __init__(self, client, name, tags):
            self.client, self.name, self.tags = client, name, tags

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.client.emit_timer(self.name, time.perf_counter() - self.t0,
                                   self.tags)

    def timing(self, name: str, tags: TagKV = None) -> "_Timing":
        return self._Timing(self, name, tags)

    def _emit(self, kind, key, value):
        for sink in self._sinks:
            sink(kind, key, value, time.time())

    def snapshot(self) -> Dict:
        with self._lock:
            return {"counters": dict(self.counters),
                    "stores": dict(self.stores),
                    "timers": {k: {"count": len(v),
                                   "mean": sum(v) / len(v) if v else 0.0}
                               for k, v in self.timers.items()}}


class FileMetricSink:
    """Appends JSON lines (ref file_metric_writer.cc)."""

    def __init__(self, path: str):
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def __call__(self, kind, key, value, ts):
        with self._lock:
            self._f.write(json.dumps({"kind": kind, "key": key,
                                      "value": value, "ts": ts}) + "\n")
            self._f.flush()


_default_client: Optional[MetricClient] = None
_default_lock = threading.Lock()


def get_metric_client(prefix: str = "monolith_tpu") -> MetricClient:
    global _default_client
    with _default_lock:
        if _default_client is None:
            _default_client = MetricClient(prefix=prefix)
    return _default_client
