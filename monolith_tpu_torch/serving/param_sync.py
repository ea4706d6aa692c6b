"""Online parameter sync: push touched embedding rows to serving replicas.

The rebuild of the reference's runtime/parameter_sync/: a push request of
delta rows (parameter_sync.proto), `SyncClientManager` holding one client
per live target with hot target refresh (sync_client_manager.h), and
request splitting of large pushes. Transport is gRPC with `codec` payloads
(no generated stubs), on the JAX package's method path, so a client of
either package pushes to an agent of the other.

Each request's packed bytes, codec header included, are at most
`max_bytes` (4 MiB, gRPC's default receive limit). The JAX package's client
sizes a chunk as `max_bytes // (row bytes + 8)`, which leaves the header
out: a full chunk then exceeds the limit by the header's bytes, the server
refuses it with RESOURCE_EXHAUSTED and `SyncClientManager.push` records -1
for the round, whose touched ids the streaming trainer has already drained.
Here the header is measured and the chunk sized to fit; the bytes on the
wire are the same format.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Sequence

import grpc
import numpy as np

from monolith_tpu_torch.embedding.host_store import shard_of_batch
from monolith_tpu_torch.serving import codec

_METHOD_PUSH = "/monolith_tpu.ParameterSync/Push"

log = logging.getLogger(__name__)


def chunk_rows(model_name: str, table: str, row_shape: tuple,
               max_bytes: int) -> int:
    """Rows of one push request whose packed bytes stay within
    `max_bytes`: the codec's header (keys, dtypes, shapes; the same for any
    row count) is measured on an empty request, then each row costs its
    8-byte fid and its f32 values."""
    head = len(codec.pack({"model_name": model_name, "table": table,
                           "fids": np.zeros(0, np.int64),
                           "embeddings": np.zeros((0, *row_shape),
                                                  np.float32)}))
    row = 8 + 4 * int(np.prod(row_shape, dtype=np.int64))
    n = (max_bytes - head) // row
    if n < 1:
        raise ValueError(f"max_bytes={max_bytes} holds no row of "
                         f"{row} bytes after a {head}-byte header")
    return n


class ParameterSyncClient:
    """Client for one serving target."""

    def __init__(self, target: str, timeout_s: float = 10.0):
        self.target = target
        self.timeout_s = timeout_s
        self._channel = grpc.insecure_channel(target)
        self._push = self._channel.unary_unary(
            _METHOD_PUSH, request_serializer=lambda b: b,
            response_deserializer=lambda b: b)

    def push(self, model_name: str, table: str, fids: np.ndarray,
             embeddings: np.ndarray, max_bytes: int = 4 << 20) -> int:
        """Chunked push (the request splitter): every request's packed
        bytes are at most `max_bytes`. Returns rows acked."""
        n = len(fids)
        if n == 0:
            return 0
        fids = np.asarray(fids, np.int64)
        embeddings = np.asarray(embeddings, np.float32)
        chunk = chunk_rows(model_name, table, embeddings.shape[1:], max_bytes)
        acked = 0
        for i in range(0, n, chunk):
            req = codec.pack({"model_name": model_name, "table": table,
                              "fids": fids[i:i + chunk],
                              "embeddings": embeddings[i:i + chunk]})
            resp = codec.unpack(self._push(req, timeout=self.timeout_s))
            acked += int(resp.get("applied", 0))
        return acked

    def close(self):
        self._channel.close()


class SyncClientManager:
    """Keeps one client per live target; targets refresh from discovery
    (the reference's sync_client_manager hot-swap from ZK)."""

    def __init__(self, model_name: str, discovery=None, service: str = "serving",
                 static_targets: Sequence[str] = ()):
        self.model_name = model_name
        self.discovery = discovery
        self.service = service
        self._static = list(static_targets)
        self._clients: Dict[str, ParameterSyncClient] = {}
        self._lock = threading.Lock()

    def refresh_targets(self) -> List[str]:
        targets = list(self._static)
        if self.discovery is not None:
            targets.extend(self.discovery.query(self.service).values())
        with self._lock:
            for t in targets:
                if t not in self._clients:
                    self._clients[t] = ParameterSyncClient(t)
            for t in list(self._clients):
                if t not in targets:
                    self._clients.pop(t).close()
        return targets

    def push_routed(self, table: str, fids: np.ndarray,
                    embeddings: np.ndarray,
                    num_row_shards: int) -> Dict[str, int]:
        """Row-sharded serving push: each fid goes ONLY to the replica
        owning its row shard (replica index i serves shard
        i % num_row_shards, by the same shard_of(fid, N) hash the serving
        loader and the router use)."""
        fids = np.asarray(fids, np.int64)
        dest = shard_of_batch(fids, num_row_shards)
        replicas: Dict[int, str] = {}
        if self.discovery is not None:
            replicas.update(self.discovery.query(self.service))
        for i, t in enumerate(self._static):
            replicas.setdefault(i, t)
        results: Dict[str, int] = {}
        with self._lock:
            for t in replicas.values():
                if t not in self._clients:
                    self._clients[t] = ParameterSyncClient(t)
            clients = dict(self._clients)
        for idx, target in replicas.items():
            sel = dest == (idx % num_row_shards)
            if not sel.any():
                results[target] = 0
                continue
            try:
                results[target] = clients[target].push(
                    self.model_name, table, fids[sel], embeddings[sel])
            except grpc.RpcError as e:
                log.warning("routed param sync push to %s failed: %s",
                            target, e)
                results[target] = -1
        return results

    def push(self, table: str, fids: np.ndarray,
             embeddings: np.ndarray) -> Dict[str, int]:
        """Push the delta to every live target; per-target ack counts (-1
        for a target whose push failed)."""
        self.refresh_targets()
        results = {}
        with self._lock:
            clients = dict(self._clients)
        for target, client in clients.items():
            try:
                results[target] = client.push(self.model_name, table, fids,
                                              embeddings)
            except grpc.RpcError as e:
                log.warning("param sync push to %s failed: %s", target, e)
                results[target] = -1
        return results

    def close(self) -> None:
        """Close every target's channel."""
        with self._lock:
            clients, self._clients = self._clients, {}
        for c in clients.values():
            c.close()
