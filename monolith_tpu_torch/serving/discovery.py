"""Service discovery (the port's copy; stdlib only).

The rebuild of the reference's service_discovery.py (a ServiceDiscovery ABC
with Consul/TfConfig/ZK implementations) and the agent's ZK replica
registry. `FileDiscovery` is the bundled backend: a shared-filesystem
registry with heartbeat liveness. The files and their JSON keys are the JAX
package's (`{name}-{index}.json` holding name, index, addr, ts), so a
registration written by either package is read by the other.
"""

from __future__ import annotations

import abc
import json
import os
import time
from typing import Dict


class ServiceDiscovery(abc.ABC):
    @abc.abstractmethod
    def register(self, name: str, index: int, addr: str) -> None:
        ...

    @abc.abstractmethod
    def deregister(self, name: str, index: int, addr: str) -> None:
        ...

    @abc.abstractmethod
    def query(self, name: str) -> Dict[int, str]:
        """name -> {replica index: addr} of live replicas."""
        ...


class FileDiscovery(ServiceDiscovery):
    """Directory-based registry: one json file per (service, index) with a
    heartbeat timestamp; entries older than ttl are considered dead."""

    def __init__(self, root: str, ttl_seconds: float = 30.0):
        self.root = root
        self.ttl = ttl_seconds
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str, index: int) -> str:
        return os.path.join(self.root, f"{name}-{index}.json")

    def register(self, name: str, index: int, addr: str) -> None:
        tmp = self._path(name, index) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"name": name, "index": index, "addr": addr,
                       "ts": time.time()}, f)
        os.replace(tmp, self._path(name, index))

    def heartbeat(self, name: str, index: int, addr: str) -> None:
        self.register(name, index, addr)

    def deregister(self, name: str, index: int, addr: str) -> None:
        try:
            os.remove(self._path(name, index))
        except FileNotFoundError:
            pass

    def query(self, name: str) -> Dict[int, str]:
        out = {}
        now = time.time()
        for fname in os.listdir(self.root):
            if not (fname.startswith(name + "-") and fname.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.root, fname)) as f:
                    e = json.load(f)
            except (json.JSONDecodeError, FileNotFoundError):
                continue
            if now - e["ts"] <= self.ttl:
                out[int(e["index"])] = e["addr"]
        return out
