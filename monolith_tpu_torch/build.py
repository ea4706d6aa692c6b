"""Builds the port's native libraries from the sources in the checkout.

Two shared libraries with a plain C interface, both loaded with ctypes:

- the host sparse core (`cpp/store.cc`, `batching.cc`, `batching2d.cc`),
  compiled with g++ and the flags of `cpp/Makefile`, with the port's own
  host source beside it (`csrc/prepare_wide.cc`: the fused prepare with
  wide tables, over cpp/'s C entry points);
- one library per CUDA source of `monolith_tpu_torch/csrc/` (`rows.cu`:
  the row gather/scatter; `rounding.cu`: stochastic rounding), each
  compiled by its own nvcc for `sm_90a`, so they can build in parallel.

Outputs go to `monolith_tpu_torch/_build/` (never into `cpp/`), under a name
that carries a hash of the sources, the command line and the host name, so
an edited source is rebuilt, a library built on another machine is not
loaded, and a stale library is never loaded. A file lock serialises
builds across processes (parallel test workers, parallel builds in
`chip_smoke.py`); the compiler writes to a temporary name that is renamed
into place, so a reader never sees half a library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
CPP_DIR = os.path.join(REPO_DIR, "cpp")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")


def build_shared(name: str, deps: Sequence[str],
                 command: Callable[[str], List[str]]) -> str:
    """Build `_build/<name>-<hash>.so` unless it exists; return its path.

    `deps` are the files whose contents key the build (sources and
    headers); `command(out_path)` returns the compiler's argv. The
    compiler's output (warnings, `-Xptxas -v` resource reports) is kept
    beside the library as `<name>.log`."""
    h = hashlib.sha256()
    for path in deps:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(command("OUT")).encode())
    # -march=native binds a library to the machine that built it
    h.update(platform.node().encode())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run(command(tmp), capture_output=True,
                                  text=True)
            with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as log:
                log.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"building {name} failed "
                                   f"(rc {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """The compiler output of the last build of `name` ('' if none)."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


#: the port's host sources, built into libmonolith_host.so beside cpp/'s
HOST_SOURCES = ("prepare_wide.cc",)


def build_host_library() -> str:
    """libmonolith_host.so from cpp/ (cpp/Makefile's flags) and the port's
    host sources."""
    srcs = [os.path.join(CPP_DIR, f)
            for f in ("store.cc", "batching.cc", "batching2d.cc")]
    srcs += [os.path.join(CSRC_DIR, f) for f in HOST_SOURCES]
    deps = srcs + [os.path.join(CPP_DIR, "threadpool.h")]
    return build_shared(
        "libmonolith_host", deps,
        lambda out: ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
                     "-march=native", "-DNDEBUG", "-shared", "-I", CPP_DIR,
                     "-o", out, *srcs, "-lpthread"])


DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


def nvcc_path() -> str:
    """The CUDA compiler; raises where the toolkit is not installed."""
    path = shutil.which("nvcc") or DEFAULT_NVCC
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return path


#: the port's CUDA sources, csrc/<name>.cu -> _build/lib<name>.so
KERNEL_SOURCES = ("rows", "rounding")


def build_kernel_library(name: str = "rows", src: str = "") -> str:
    """lib<name>.so: the kernels of csrc/<name>.cu for sm_90a (or of `src`,
    another source with the same C interface, built with the same command:
    bench_rows.py times an earlier commit's kernels that way)."""
    src = src or os.path.join(CSRC_DIR, f"{name}.cu")
    nvcc = nvcc_path()
    return build_shared(
        f"lib{name}", [src],
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", "-o", out, src])


_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def load_kernel_library(name: str,
                        declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """lib<name>.so loaded with ctypes (built at first use); `declare`
    sets its functions' argtypes once, before any caller sees it."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        if name not in _loaded:
            lib = ctypes.CDLL(build_kernel_library(name))
            declare(lib)
            _loaded[name] = lib
    return _loaded[name]
