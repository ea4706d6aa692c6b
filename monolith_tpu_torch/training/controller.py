"""Live training control and debugging service.

The rebuild of the reference's per-worker controller gRPC service
(StopTraining / ResumeTraining / SaveCheckpoint / GetTrainingStatus on the
running trainer) merged with its debugging server (live table stats): one
gRPC service bound to a running trainer through a hook. Method paths and
`codec` payloads are the JAX package's, and so are the status keys: the
port's engine holds one host store a table, so a table's size is
`table:{name}:s0:size`.

Usage:
    ctl = TrainingController(trainer, ckpt_dir=...)
    addr = ctl.start()          # gRPC server
    trainer.train(data, hooks=[ctl.hook])
"""

from __future__ import annotations

import threading
import time
from concurrent import futures
from typing import Dict, Optional

import grpc

from monolith_tpu_torch.serving import codec
from monolith_tpu_torch.training import checkpoint
from monolith_tpu_torch.training.hooks import machine_info
from monolith_tpu_torch.utils.metrics_client import get_metric_client

_SERVICE = "monolith_tpu.TrainingController"


class _Handler(grpc.GenericRpcHandler):
    def __init__(self, ctl):
        self._methods = {
            "StopTraining": ctl._rpc_stop,
            "ResumeTraining": ctl._rpc_resume,
            "SaveCheckpoint": ctl._rpc_save,
            "GetTrainingStatus": ctl._rpc_status,
            "GetBlockStatus": ctl._rpc_status,
        }

    def service(self, hcd):
        fn = self._methods.get(hcd.method.rsplit("/", 1)[-1])
        if fn is None or not hcd.method.startswith(f"/{_SERVICE}/"):
            return None
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=lambda b: b,
            response_serializer=lambda b: b)


class TrainingController:
    def __init__(self, trainer, ckpt_dir: Optional[str] = None, port: int = 0):
        self.trainer = trainer
        self.ckpt_dir = ckpt_dir
        self._paused = threading.Event()
        self._save_requested = threading.Event()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((_Handler(self),))
        self.port = self._server.add_insecure_port(f"[::]:{port}")
        self.addr = f"localhost:{self.port}"

    # --- rpc impls ---

    def _rpc_stop(self, request, context):
        self._paused.set()
        return codec.pack({"ok": 1, "paused": 1})

    def _rpc_resume(self, request, context):
        self._paused.clear()
        return codec.pack({"ok": 1, "paused": 0})

    def _rpc_save(self, request, context):
        if self.ckpt_dir is None:
            return codec.pack({"ok": 0, "error": "no ckpt_dir configured"})
        self._save_requested.set()
        return codec.pack({"ok": 1})

    def _rpc_status(self, request, context):
        t = self.trainer
        # metrics accumulate on the device; a status RPC is an explicit
        # request, so the one readback here is acceptable
        t._drain_metrics()
        status: Dict = {"step": t.step,
                        "paused": int(self._paused.is_set()),
                        "loss": float(t.loss_mean.result()),
                        "auc": float(t.auc.result())}
        for tname, stores in t.engine.shard_stores.items():
            for s, store in enumerate(stores):
                if store is not None:   # a multi-host rank holds its own
                    status[f"table:{tname}:s{s}:size"] = store.size()
        info = machine_info()
        for k in ("load1", "mem_available_kb"):
            if k in info:
                status[f"machine:{k}"] = info[k]
        snap = get_metric_client().snapshot()
        for k, v in snap["stores"].items():
            status[f"metric:{k}"] = v
        return codec.pack(status)

    # --- trainer-side hook ---

    def hook(self, trainer, out):
        """Install as a training hook: honours save and pause requests
        between dispatches (the reference's barrier quiesce)."""
        if self._save_requested.is_set():
            checkpoint.save(trainer, self.ckpt_dir)
            self._save_requested.clear()
        while self._paused.is_set():
            time.sleep(0.05)

    # --- lifecycle ---

    def start(self) -> str:
        self._server.start()
        return self.addr

    def stop(self):
        self._server.stop(grace=0.5).wait()


class ControllerClient:
    """The client side of the controller service."""

    def __init__(self, target: str, timeout_s: float = 10.0):
        self.timeout_s = timeout_s
        self._channel = grpc.insecure_channel(target)

        def method(name):
            rpc = self._channel.unary_unary(
                f"/{_SERVICE}/{name}", request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
            return lambda: codec.unpack(rpc(codec.pack({}),
                                            timeout=self.timeout_s))
        self.stop_training = method("StopTraining")
        self.resume_training = method("ResumeTraining")
        self.save_checkpoint = method("SaveCheckpoint")
        self.get_status = method("GetTrainingStatus")

    def close(self):
        self._channel.close()
