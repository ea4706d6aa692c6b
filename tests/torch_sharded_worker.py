"""Rank process of the port's sharded-trainer tests (tests/test_torch_sharded.py).

    python tests/torch_sharded_worker.py JOB RANK WORLD PORT OUT

joins a gloo group of WORLD ranks at tcp://localhost:PORT, runs the job
pickled in JOB (a scenario of ShardedTrainer runs on the CPU, from a
carried JAX state) and pickles this rank's results into OUT. It imports the
port and torch, never JAX. `run_ranks` (imported by the tests) starts the
WORLD processes, waits for them under a time limit and raises with the
failing rank's output; `start_ranks` and `main` serve the multi-host
trainer's worker (tests/torch_multihost_worker.py) too.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(world: int, job: dict, script: str = __file__):
    """Start `world` rank processes of `script` (this file, or another
    rank worker whose main is `main` with its own scenario) on `job`;
    returns a handle for wait_ranks (the parent can work while they
    run)."""
    tmp = tempfile.mkdtemp(prefix="torch_ranks_")
    path = os.path.join(tmp, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    outs = [os.path.join(tmp, f"out{r}.pkl") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script), path, str(r), str(world),
         str(port), outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    return procs, outs


def wait_ranks(handle, timeout: float = 240.0):
    """Every rank's results, in rank order; raises AssertionError with the
    failing rank's output if one fails or the time runs out (every rank
    is then killed)."""
    procs, outs = handle
    deadline = time.time() + timeout
    logs = [None] * len(procs)
    try:
        for r, p in enumerate(procs):
            try:
                logs[r], _ = p.communicate(timeout=max(1.0,
                                                       deadline - time.time()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} did not finish in {timeout} s")
            if p.returncode != 0:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                     f"{logs[r][-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def run_ranks(world: int, job: dict, timeout: float = 240.0):
    return wait_ranks(start_ranks(world, job), timeout)


# ----------------------------------------------------------------------
# inside a rank
# ----------------------------------------------------------------------

def _hash(arrays) -> str:
    h = hashlib.sha1()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        else:
            import numpy as np
            a = np.ascontiguousarray(x)
            h.update(str(a.dtype).encode() + str(a.shape).encode())
            h.update(a.tobytes())

    walk(arrays)
    return h.hexdigest()


def _same_on_every_rank(value, what: str):
    """Assert that every rank holds `value` (compared by pickle)."""
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    assert all(g == got[0] for g in got), f"{what} differs across ranks"


class _Trainers:
    """Builds ShardedTrainers from the job's task and engine settings,
    each loaded with a carried state, and records every host prepare's
    arrays by hash."""

    def __init__(self, job, mesh):
        self.job, self.mesh = job, mesh
        self.hashes = []

    def make(self, state, **engine):
        from monolith_tpu_torch import convert
        from monolith_tpu_torch.embedding.engine import EngineConfig
        from monolith_tpu_torch.models.deepfm import DeepFMTask
        from monolith_tpu_torch.parallel import ShardedTrainer
        from monolith_tpu_torch.training.trainer import TrainerConfig
        job = self.job
        cfg = TrainerConfig(
            engine=EngineConfig(**dict(job["engine"], **engine)),
            log_every=0, seed=job["seed"],
            steps_per_dispatch=job.get("steps_per_dispatch", 1))
        tr = ShardedTrainer(DeepFMTask(**job["task"]), cfg, self.mesh)
        convert.load_state(tr, state)
        for name in ("prepare_shards", "prepare_batch_a2a"):
            real = getattr(tr.engine, name)

            def spy(fb, ts, real=real):
                inputs, stats = real(fb, ts)
                self.hashes.append(_hash(inputs))
                return inputs, stats
            setattr(tr.engine, name, spy)
        return tr


def _snapshot(tr):
    """The rank's pool (f32) and the dense state in flax form."""
    from monolith_tpu_torch import convert
    st = convert.export_state(tr)
    return {"pool": {t: p[0] for t, p in st["tables"].items()},
            "params": st["params"], "opt_state": st["opt_state"],
            "stores": st["stores"], "step": st["step"]}


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.detach().cpu().numpy().copy()


def scenario(job, mesh):
    """Per-step train steps, a synchronous block, their sequential twin,
    `train()` in blocks, an asynchronous block, evaluate (also of the
    state loaded into an allgather trainer), expiry, predict, the
    mesh-size refusals and, when asked, a step with overflowing
    buckets."""
    from monolith_tpu_torch import convert
    pairs, state0 = job["pairs"], job["state0"]
    ts0 = job["ts0"]
    make = _Trainers(job, mesh)
    res = {"rank": mesh.rank}

    # per-step steps, then a synchronous block
    tr = make.make(state0)
    n_steps, K = job["steps"], job["K"]
    res["steps"] = []
    for i in range(n_steps):
        out = tr.train_step(*pairs[i], ts=ts0 + i)
        snap = _snapshot(tr)
        _same_on_every_rank(_hash(snap["params"]), f"params after step {i}")
        res["steps"].append({"loss": float(out["loss"]),
                             "preds": _np(out["preds"]),
                             "stats": out["stats"],
                             "params": snap["params"]})
    res["after_steps"] = _snapshot(tr)
    block = pairs[n_steps:n_steps + K]
    out = tr.train_step_block(block, ts=ts0 + n_steps)
    res["block"] = {"loss": _np(out["loss"]), "preds": _np(out["preds"]),
                    "stats": out["stats"]}
    res["after_block"] = _snapshot(tr)
    _same_on_every_rank(_hash(res["after_block"]["params"]),
                        "params after the block")

    # the same batches as sequential steps: equal bit for bit
    seq = make.make(state0)
    for i in range(n_steps + K):
        seq.train_step(*pairs[i], ts=ts0 + i if i < n_steps
                       else ts0 + n_steps)
    res["sequential"] = _snapshot(seq)

    # train() in blocks of K with the staging lookahead, against steps
    blocked = _Trainers(dict(job, steps_per_dispatch=K), mesh).make(state0)
    calls = {"n": 0}
    real_stage = blocked.stage_block

    def counted(p, ts=None):
        calls["n"] += 1
        return real_stage(p, ts=ts)
    blocked.stage_block = counted
    r_blocked = blocked.train(iter(pairs[:2 * K]), steps=2 * K)
    steps = make.make(state0)
    r_steps = steps.train(iter(pairs[:2 * K]), steps=2 * K)
    res["train_blocked"] = dict(r_blocked, snap=_snapshot(blocked),
                                staged=calls["n"], step=blocked.step)
    res["train_steps"] = dict(r_steps, snap=_snapshot(steps))

    # a synchronous block from the carried state, beside the asynchronous
    sync = make.make(state0)
    sync.train_step_block(pairs[:K], ts=ts0)
    res["sync_first_block"] = _snapshot(sync)

    # the 1-step-stale asynchronous block
    tra = make.make(state0, async_optimize=True)
    out = tra.train_step_block(pairs[:K], ts=ts0)
    res["async"] = {"loss": _np(out["loss"]), "preds": _np(out["preds"]),
                    "after": _snapshot(tra)}

    # evaluate the block-trained state; the same state loaded into an
    # allgather trainer evaluates alike
    res["eval"] = tr.evaluate(iter(job["evals"]))
    st = convert.export_state(tr)
    res["freed"] = tr.evict_expired(job["expire_before"])
    res["after_evict"] = _snapshot(tr)
    ag = make.make(st, exchange="allgather")
    res["eval_allgather"] = ag.evaluate(iter(job["evals"]))

    res["predict"] = _np(tr.predict(*job["evals"][0]))

    try:
        make.make(state0, num_shards=mesh.size + 1)
        res["mismatch_raised"] = False
    except ValueError as e:
        res["mismatch_raised"] = "mesh size" in str(e)
    from monolith_tpu_torch.parallel import make_mesh
    try:
        make_mesh(mesh.size + 1, device="cpu")
        res["too_many_raised"] = False
    except ValueError as e:
        res["too_many_raised"] = "need" in str(e)

    if job.get("overflow"):
        o = job["overflow"]
        tro = make.make(o["state"], bucket_cap=o["bucket_cap"])
        out = tro.train_step(*o["pair"], ts=o["ts"])
        res["overflow"] = {"loss": float(out["loss"]), "stats": out["stats"],
                           "after": _snapshot(tro)}

    _same_on_every_rank(make.hashes, "host prepare arrays")
    res["host_hashes"] = make.hashes
    return res


def main(argv, run=None):
    """Join the gloo group, run `run(job, mesh)` (this file's scenario by
    default) and pickle its results."""
    job_path, rank, world, port, out_path = argv
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=int(rank), world_size=int(world))
    try:
        from monolith_tpu_torch.parallel import make_mesh
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        mesh = make_mesh(device="cpu")
        res = (run or scenario)(job, mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
