"""Deep-insight style per-example quality emission.

The port's copy of the JAX package's utils/deep_insight.py: ref
runtime/deep_insight/deep_insight.h:67 +
metric/deep_insight_ops.py:30-88: emit downsampled per-example records
{model_name, req_time, label, pred, sample_rate, extra fields} for online
model-quality monitoring. The open-source reference writes to a stub sink;
here records go to a pluggable sink (JSON-lines file or in-memory buffer for
tests/inspection).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class DeepInsightClient:
    def __init__(self, model_name: str, sample_rate: float = 0.01,
                 sink: Optional[Callable[[dict], None]] = None,
                 buffer_limit: int = 100_000, seed: int = 0):
        self.model_name = model_name
        self.sample_rate = sample_rate
        self._rng = np.random.default_rng(seed)
        self._sink = sink
        self.buffer: List[dict] = []
        self._lock = threading.Lock()
        self.buffer_limit = buffer_limit
        self.emitted = 0

    def emit(self, labels, preds, uids=None, req_time: Optional[int] = None,
             extra: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Emit a batch; returns number of sampled records."""
        labels = np.asarray(labels).ravel()
        preds = np.asarray(preds).ravel()
        n = len(labels)
        take = self._rng.random(n) < self.sample_rate
        idx = np.nonzero(take)[0]
        req_time = int(time.time() * 1000) if req_time is None else req_time
        for i in idx:
            rec = {"model_name": self.model_name,
                   "req_time": req_time,
                   "label": float(labels[i]),
                   "pred": float(preds[i]),
                   "sample_rate": self.sample_rate}
            if uids is not None:
                rec["uid"] = int(np.asarray(uids).ravel()[i])
            if extra:
                for k, v in extra.items():
                    rec[k] = float(np.asarray(v).ravel()[i])
            if self._sink is not None:
                self._sink(rec)
            else:
                with self._lock:
                    if len(self.buffer) < self.buffer_limit:
                        self.buffer.append(rec)
        self.emitted += len(idx)
        return len(idx)


class JsonFileSink:
    def __init__(self, path: str):
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def __call__(self, rec: dict):
        with self._lock:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
