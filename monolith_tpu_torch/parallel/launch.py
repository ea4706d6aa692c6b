"""Start S local ranks of one function: the port's counterpart of the JAX
package's one-process mesh over S local devices.

The JAX package drives S devices from one process (`make_mesh(S)`); the
port runs one process a rank (parallel/mesh.py). `launch(fn, S)` starts
the S processes itself, as a user would with `torchrun`, and waits for
them:

    from monolith_tpu_torch.parallel.launch import launch
    results = launch(fn, 4)                          # NCCL, rank r on cuda:r
    results = launch(fn, 2, backend="gloo", device="cuda:0")   # one card
    results = launch(fn, 4, device="cpu")            # gloo on the CPU

Each rank is a fresh Python process (`python -m
monolith_tpu_torch.parallel.launch JOB RANK`) that imports `fn` by its
module and name (a function of the script being run is imported from the
script's file, as multiprocessing's spawn does), joins the group at a free
port on localhost (`init_process_group(init_method="tcp://localhost:..."`),
calls `fn(rank, *args)` and leaves the group. The call returns the ranks'
return values in rank order. The launcher sets the variables torchrun
sets (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) and the rank's device, which `rank_device()` reads.

Each rank's output goes to a file; when every rank has succeeded, rank
0's standard output and error are written to the caller's. When a rank
fails, every other rank is killed (after a moment in which a rank whose
peer died may fail by itself) and the call raises `RankFailed` with the
exit codes and the end of the output of the ranks that failed: a launch
never returns with a rank down.

Placement: by default NCCL, rank r on `cuda:r`; more ranks than cards are
refused, as the JAX package's `make_mesh(S)` refuses with fewer devices,
and there is no fallback to gloo or to the CPU. Ranks share one card only
when asked: `backend="gloo", device="cuda:0"`. `device="cpu"` runs gloo
ranks on the CPU.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

#: the environment variable that carries a launched rank's device
DEVICE_ENV = "MONOLITH_TORCH_RANK_DEVICE"

_POLL_S = 0.05
_GRACE_S = 5.0
_TAIL_CHARS = 6000


class RankFailed(RuntimeError):
    """A launched rank exited with an error."""


def rank_device() -> Optional[str]:
    """The device `launch` gave this rank ("cuda:1", "cuda:0", "cpu"), or
    None in a process it did not start."""
    return os.environ.get(DEVICE_ENV)


def placement(num_ranks: int, backend: Optional[str] = None,
              device=None) -> tuple:
    """(backend, [device of rank r]) for a launch, or ValueError /
    RuntimeError for one that cannot run as asked."""
    import torch
    if num_ranks < 1:
        raise ValueError(f"num_ranks must be >= 1 (got {num_ranks})")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo' (got {backend!r})")
    if device is not None and torch.device(device).type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL ranks run on the cards; device='cpu' "
                             "takes gloo")
        return "gloo", ["cpu"] * num_ranks
    if not torch.cuda.is_available():
        raise RuntimeError("launch places its ranks on the cards and CUDA is "
                           "not available; pass device='cpu' for gloo ranks "
                           "on the CPU")
    cards = torch.cuda.device_count()
    if device is None:
        if num_ranks > cards:
            raise ValueError(
                f"{num_ranks} ranks need {num_ranks} cards and this machine "
                f"has {cards}: refused, as a mesh of more devices than "
                f"exist is (ranks share a card only when asked: "
                f"backend='gloo', device='cuda:0')")
        return backend or "nccl", [f"cuda:{r}" for r in range(num_ranks)]
    dev = torch.device(device)
    index = 0 if dev.index is None else dev.index
    if index >= cards:
        raise ValueError(f"device {device} is not one of the {cards} cards")
    if num_ranks > 1 and backend != "gloo":
        raise ValueError(f"{num_ranks} ranks on one card ({device}) need "
                         f"backend='gloo': NCCL takes one card a rank")
    return backend or "nccl", [f"cuda:{index}"] * num_ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _function_ref(fn: Callable) -> dict:
    """How a rank imports `fn`: its module and qualified name, and for a
    function of the script being run, that script's file."""
    module, name = fn.__module__, fn.__qualname__
    if "<locals>" in name or "<lambda>" in name:
        raise ValueError(f"launch needs a module-level function, not "
                         f"{module}.{name}")
    ref = {"module": module, "name": name, "file": None}
    if module == "__main__":
        main = sys.modules["__main__"]
        spec = getattr(main, "__spec__", None)
        if spec is not None and spec.name:
            ref["module"] = spec.name
        elif getattr(main, "__file__", None):
            ref["file"] = os.path.abspath(main.__file__)
        else:
            raise ValueError(f"launch cannot import {name} from an "
                             f"interactive __main__")
    return ref


def _resolve(ref: dict) -> Callable:
    if ref["file"] is not None:
        spec = importlib.util.spec_from_file_location("__launch_main__",
                                                      ref["file"])
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(ref["module"])
    obj = module
    for part in ref["name"].split("."):
        obj = getattr(obj, part)
    return obj


def _tail(path: str) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-_TAIL_CHARS:]


def launch(fn: Callable, num_ranks: int, *, backend: Optional[str] = None,
           device=None, args: Sequence[Any] = ()) -> List[Any]:
    """Run `fn(rank, *args)` in `num_ranks` local processes joined in one
    torch.distributed group and wait for them. Returns the ranks' return
    values in rank order; raises RankFailed (the others killed) if any
    rank fails. `fn` and `args` must pickle (`fn` by reference: a
    module-level function)."""
    backend, devices = placement(num_ranks, backend, device)
    ref = _function_ref(fn)
    work = tempfile.mkdtemp(prefix="monolith_launch_")
    procs: List[subprocess.Popen] = []
    files = []
    try:
        job = os.path.join(work, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"fn": ref, "args": tuple(args), "backend": backend,
                         "sys_path": [p or os.getcwd() for p in sys.path]},
                        f)
        port = _free_port()
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = os.environ.get("PYTHONPATH")
        for r in range(num_ranks):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(num_ranks),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(num_ranks),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       PYTHONPATH=root + (os.pathsep + path if path else ""))
            env[DEVICE_ENV] = devices[r]
            out, err = (os.path.join(work, f"rank{r}.{k}")
                        for k in ("out", "err"))
            files.append((out, err, os.path.join(work, f"rank{r}.pkl")))
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "monolith_tpu_torch.parallel.launch",
                     job, str(r)], stdout=fo, stderr=fe, stdin=subprocess.DEVNULL,
                    env=env))
        _wait(procs, files)
        sys.stdout.write(open(files[0][0]).read())
        sys.stdout.flush()
        sys.stderr.write(open(files[0][1]).read())
        results = []
        for _, _, res in files:
            with open(res, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


def _wait(procs, files) -> None:
    """Until every rank has exited 0. On a failure, the other ranks get a
    moment to fail by themselves (a rank whose peer died fails too), then
    RankFailed carries the output of every rank that failed."""
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            grace = time.time() + _GRACE_S
            while time.time() < grace and any(c is None for c in codes):
                time.sleep(_POLL_S)
                codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            raise RankFailed(
                f"rank {', '.join(map(str, failed))} of {len(procs)} "
                f"exited {[codes[r] for r in failed]}; their output:\n"
                + "\n".join(f"--- rank {r} ---\n{_tail(files[r][0])}\n"
                            f"{_tail(files[r][1])}" for r in failed))
        if all(c == 0 for c in codes):
            return
        time.sleep(_POLL_S)


def _rank_main(job_path: str, rank: int) -> None:
    """Inside a rank: join the group, run the function, pickle its result
    beside its output files."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    sys.path.extend(p for p in job["sys_path"] if p not in sys.path)
    import torch
    import torch.distributed as dist
    device = rank_device()
    world = int(os.environ["WORLD_SIZE"])
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    elif "OMP_NUM_THREADS" not in os.environ:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        job["backend"], rank=rank, world_size=world,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"))
    try:
        result = _resolve(job["fn"])(rank, *job["args"])
    finally:
        dist.destroy_process_group()
    out = os.path.join(os.path.dirname(job_path), f"rank{rank}.pkl")
    with open(out, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
