"""Serving agent: hosts a ServingModel behind gRPC.

The rebuild of the reference's agent_service (an agent launching
TF-Serving and registering replicas in ZK) collapsed into one process: the
model server is the agent. It serves Predict, ReloadDense and Lookup (the
embedding-shard role behind `ShardedServingRouter`) and ParameterSync.Push,
registers in discovery with heartbeats, and can watch an export directory
for new versions.

Method paths and payloads are the JAX package's (`/monolith_tpu.
ParameterSync/Push`, `/monolith_tpu.Predict/{Predict,ReloadDense,Lookup}`,
`codec` bytes both ways), so a client of either package calls an agent of
the other. gRPC runs the handlers on its pool threads; `ServingModel`
takes its version lock around what must see one version, and on the card
writes a push into the pool in place (see `serving/engine.py`).
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent import futures
from typing import Dict, Optional

import grpc
import numpy as np

from monolith_tpu_torch.serving import codec
from monolith_tpu_torch.serving.discovery import ServiceDiscovery
from monolith_tpu_torch.serving.engine import ServingModel

log = logging.getLogger(__name__)

_SERVICE = "monolith_tpu.ParameterSync"
_PREDICT_SERVICE = "monolith_tpu.Predict"


def _bytes_method(fn):
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=lambda b: b,
        response_serializer=lambda b: b)


class VersionWatcher(threading.Thread):
    """Polls an export base dir's EXPORT pointer (written LAST by
    export_model, so it marks a complete export) and hot-swaps the model to
    new versions through ServingModel.reload_export: the reference's
    tfs_monitor + replica_manager version loop."""

    def __init__(self, model: ServingModel, base_dir: str,
                 poll_s: float = 10.0):
        super().__init__(daemon=True)
        self.model = model
        self.base_dir = base_dir
        self.poll_s = poll_s
        # not `_stop`: that would shadow Thread._stop, which join() calls
        self._stopped = threading.Event()
        self.swaps = 0

    def _latest_step(self) -> Optional[int]:
        try:
            with open(os.path.join(self.base_dir, "EXPORT")) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def poll_once(self) -> bool:
        """One poll: swap if the pointer advanced. Returns True on swap."""
        step = self._latest_step()
        if step is None or step <= self.model.step:
            return False
        path = os.path.join(self.base_dir, f"export-{step}")
        new_step = self.model.reload_export(path)
        self.swaps += 1
        log.info("version watcher: hot-swapped to export step %d", new_step)
        return True

    def run(self):
        while not self._stopped.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # keep serving on a bad/partial export
                log.exception("version watcher: reload failed; still on "
                              "step %d", self.model.step)

    def stop(self):
        self._stopped.set()


class _Handler(grpc.GenericRpcHandler):
    def __init__(self, agent: "ServingAgent"):
        self._methods = {
            f"/{_SERVICE}/Push": agent._handle_push,
            f"/{_PREDICT_SERVICE}/Predict": agent._handle_predict,
            f"/{_PREDICT_SERVICE}/ReloadDense": agent._handle_reload_dense,
            f"/{_PREDICT_SERVICE}/Lookup": agent._handle_lookup,
        }

    def service(self, handler_call_details):
        fn = self._methods.get(handler_call_details.method)
        return None if fn is None else _bytes_method(fn)


class ServingAgent:
    def __init__(self, model: ServingModel, port: int = 0,
                 discovery: Optional[ServiceDiscovery] = None,
                 service_name: str = "serving", replica_index: int = 0,
                 heartbeat_s: float = 5.0, watch_dir: Optional[str] = None,
                 watch_poll_s: float = 10.0):
        self.model = model
        self.watcher = (VersionWatcher(model, watch_dir, watch_poll_s)
                        if watch_dir else None)
        self.discovery = discovery
        self.service_name = service_name
        self.replica_index = replica_index
        self.heartbeat_s = heartbeat_s
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((_Handler(self),))
        self.port = self._server.add_insecure_port(f"[::]:{port}")
        self.addr = f"localhost:{self.port}"
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    # --- rpc handlers ---

    def _handle_push(self, request: bytes, context) -> bytes:
        req = codec.unpack(request)
        applied = self.model.apply_delta(req["table"], req["fids"],
                                         req["embeddings"])
        return codec.pack({"applied": applied})

    def _handle_predict(self, request: bytes, context) -> bytes:
        req = codec.unpack(request)
        fid_batch = {k[4:]: v for k, v in req.items() if k.startswith("fid:")}
        batch = {k[6:]: v for k, v in req.items() if k.startswith("batch:")}
        preds = self.model.predict(fid_batch, batch)
        return codec.pack({"preds": preds})

    def _handle_reload_dense(self, request: bytes, context) -> bytes:
        req = codec.unpack(request)
        self.model.reload_dense(req["dense"])
        return codec.pack({"ok": 1})

    def _handle_lookup(self, request: bytes, context) -> bytes:
        # the embedding-shard role (the reference's per-PS raw lookup
        # serving signature): raw id -> value rows
        req = codec.unpack(request)
        vals = self.model.lookup_rows(req["table"], req["fids"])
        return codec.pack({"values": vals})

    # --- lifecycle ---

    def start(self) -> str:
        self._server.start()
        if self.discovery is not None:
            self.discovery.register(self.service_name, self.replica_index,
                                    self.addr)

            def beat():
                while not self._stop.wait(self.heartbeat_s):
                    self.discovery.heartbeat(self.service_name,
                                             self.replica_index, self.addr)

            self._hb_thread = threading.Thread(target=beat, daemon=True)
            self._hb_thread.start()
        if self.watcher is not None:
            self.watcher.start()
        log.info("serving agent on %s", self.addr)
        return self.addr

    def stop(self) -> None:
        """Stop serving: end the heartbeat (before deregistering, so that
        no late beat registers again) and the watcher, deregister, and wait
        for the server (up to 1 s of grace for calls in flight)."""
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join()
        if self.watcher is not None:
            self.watcher.stop()
            if self.watcher.is_alive():
                self.watcher.join()
        if self.discovery is not None:
            self.discovery.deregister(self.service_name, self.replica_index,
                                      self.addr)
        self._server.stop(grace=1.0).wait()


class ServingClient:
    """Client for a ServingAgent (the reference's svr_client / remote
    predict)."""

    def __init__(self, target: str, timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        self._channel = grpc.insecure_channel(target)

        def method(name):
            return self._channel.unary_unary(
                f"/{_PREDICT_SERVICE}/{name}",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
        self._predict = method("Predict")
        self._reload = method("ReloadDense")
        self._lookup = method("Lookup")

    def predict(self, fid_batch: Dict[str, np.ndarray],
                batch: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        payload = {f"fid:{k}": np.asarray(v, np.int64)
                   for k, v in fid_batch.items()}
        for k, v in (batch or {}).items():
            payload[f"batch:{k}"] = np.asarray(v)
        resp = codec.unpack(self._predict(codec.pack(payload),
                                          timeout=self.timeout_s))
        return resp["preds"]

    def reload_dense(self, dense_bytes: bytes) -> None:
        self._reload(codec.pack({"dense": dense_bytes}), timeout=self.timeout_s)

    def lookup(self, table: str, fids: np.ndarray) -> np.ndarray:
        """Raw embedding lookup on a shard replica (the router's fan-out)."""
        resp = codec.unpack(self._lookup(
            codec.pack({"table": table, "fids": np.asarray(fids, np.int64)}),
            timeout=self.timeout_s))
        return resp["values"]

    def close(self):
        self._channel.close()
