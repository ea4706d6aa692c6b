"""Serving: model export, the serving-side inference engine, discovery,
the gRPC agent and parameter-sync client, and the payload codec.

The names that serve RPCs (the agent's and the sync client's) import
`grpc`, so they load at first use: importing this package for
`ServingModel` does not import `grpc`."""

import importlib

from monolith_tpu_torch.serving import codec
from monolith_tpu_torch.serving.discovery import FileDiscovery, ServiceDiscovery
from monolith_tpu_torch.serving.engine import ServingModel
from monolith_tpu_torch.serving.export import export_model, latest_export

_RPC_NAMES = {
    "ServingAgent": "agent", "ServingClient": "agent",
    "VersionWatcher": "agent",
    "ParameterSyncClient": "param_sync", "SyncClientManager": "param_sync",
}

__all__ = ["FileDiscovery", "ServiceDiscovery", "ServingModel", "codec",
           "export_model", "latest_export", *_RPC_NAMES]


def __getattr__(name):
    module = _RPC_NAMES.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
