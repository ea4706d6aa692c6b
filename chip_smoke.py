#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (monolith_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (it
needs one card and exits non-zero without CUDA). Phases, none of whose
failures is caught:

  1. the card's name and power limit (nvidia-smi);
  2. build the host library (g++) and the K1/K2 kernels (nvcc, sm_90a)
     from the checkout's sources, in parallel;
  3. K1 (gather_rows) and K2 (scatter_rows) against their plain versions at
     the main path's shapes (pool [2^21, 128] f32, 32768 rows, ~10% -1):
     bit-exact; each timed (kernel, plain version, one library call) beside
     its bound;
  4. the main path: full-width DeepFM (bench.py's deepfm config: capacity
     2^21, unique_cap 32768, batch 8192, hidden (256, 128, 64)) through
     Trainer.train_step for 10 steps and Trainer.evaluate for 2 batches,
     with the kernels' launch counts read right after;
  5. a small trainer on the card and on the CPU from one carried state,
     3 steps each: losses agree to rtol 1e-4;
  6. the port's NORTHSTAR (6000 steps, batch 1024, data seed 7) trained on
     the card: eval AUC inside NORTHSTAR_BAND.

TF32 is off for matrix products and convolutions (torch.backends), so the
card's dense tower runs in full f32 like the CPU's. The second-to-last line
is the kernels' JSON; the last is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
CAP, WIDTH, U = 1 << 21, 128, 32768


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20):
    """Mean device time of fn() over `reps` runs, each after a 256 MB write
    that evicts the 50 MB L2 (the main path finds these rows cold)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def phase_build():
    from monolith_tpu_torch import build
    results, errors = {}, []

    def run(name, fn):
        try:
            t0 = time.time()
            results[name] = (fn(), time.time() - t0)
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    threads = [threading.Thread(target=run, args=(n, f)) for n, f in
               (("host", build.build_host_library),
                ("kernels", build.build_kernel_library))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, (path, secs) in results.items():
        log(f"built {name}: {os.path.relpath(path)} in {secs:.1f} s")
    log("ptxas: " + " | ".join(
        ln.strip() for ln in build.build_log("librows").splitlines()
        if "registers" in ln or "Compiling" in ln))


def phase_kernels():
    """K1/K2 at the main path's shapes against their plain versions."""
    import torch
    from monolith_tpu_torch.ops import scatter as ops
    g = torch.Generator(device="cuda").manual_seed(0)
    pool = torch.randn((CAP, WIDTH), generator=g, device="cuda")
    rows = torch.randperm(CAP, generator=g, device="cuda")[:U].to(torch.int32)
    rows[torch.rand(U, generator=g, device="cuda") < 0.1] = -1
    values = torch.randn((U, WIDTH), generator=g, device="cuda")
    valid = rows >= 0
    n_valid = int(valid.sum())
    row_bytes = WIDTH * 4

    out = ops.gather_rows(pool, rows)
    ref = ops.gather_rows_plain(pool, rows)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), \
        "gather_rows differs from its plain version"
    gather_err = float((out - ref).abs().max())

    pool_k, pool_p = pool.clone(), pool.clone()
    ops.scatter_rows(pool_k, rows, values)
    ops.scatter_rows_plain(pool_p, rows, values)
    torch.cuda.synchronize()
    assert torch.equal(pool_k.view(torch.int32), pool_p.view(torch.int32)), \
        "scatter_rows differs from its plain version"
    scatter_err = float((pool_k - pool_p).abs().max())
    del pool_p, ref, out

    safe = rows.clamp(min=0).long()
    vrows, vvals = rows[valid].long(), values[valid]
    k1 = {"name": "gather_rows", "route": "cuda",
          "source": "monolith_tpu_torch/csrc/rows.cu",
          "replaces": "monolith_tpu/ops/scatter.py:143",
          "shape": f"pool [{CAP},{WIDTH}] f32, rows [{U}] ({n_valid} valid)",
          "max_abs_err": gather_err,
          "ms": time_ms(lambda: ops.gather_rows(pool, rows)),
          "plain_ms": time_ms(lambda: ops.gather_rows_plain(pool, rows)),
          # rows read + valid pool rows read + every output row written
          "bound_ms": (U * 4 + n_valid * row_bytes + U * row_bytes)
          / HBM_BYTES_PER_S * 1e3,
          "bound_by": "bytes",
          "library_ms": time_ms(lambda: torch.index_select(pool, 0, safe))}
    k2 = {"name": "scatter_rows", "route": "cuda",
          "source": "monolith_tpu_torch/csrc/rows.cu",
          "replaces": "monolith_tpu/ops/scatter.py:177",
          "shape": f"pool [{CAP},{WIDTH}] f32, rows [{U}] ({n_valid} valid)",
          "max_abs_err": scatter_err,
          "ms": time_ms(lambda: ops.scatter_rows(pool_k, rows, values)),
          "plain_ms": time_ms(lambda: ops.scatter_rows_plain(pool_k, rows,
                                                             values)),
          # rows read + valid value rows read + valid pool rows written
          "bound_ms": (U * 4 + 2 * n_valid * row_bytes)
          / HBM_BYTES_PER_S * 1e3,
          "bound_by": "bytes",
          "library_ms": time_ms(lambda: pool_k.index_copy_(0, vrows, vvals))}
    for k in (k1, k2):
        log(f"{k['name']}: bit-exact; {k['ms']:.4f} ms (plain "
            f"{k['plain_ms']:.4f}, library {k['library_ms']:.4f}, bound "
            f"{k['bound_ms']:.4f})")
    return [k1, k2]


def phase_main_path():
    """Full-width DeepFM: 10 train steps + 2 eval batches; returns the
    kernels' launch counts over exactly that run."""
    import torch
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.ops import scatter as ops
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    steps, evals, batch = 10, 2, 8192
    trainer = Trainer(DeepFMTask(embedding_dim=16, capacity_per_shard=CAP,
                                 hidden=(256, 128, 64)),
                      TrainerConfig(engine=EngineConfig(
                          num_shards=1, unique_cap=U, new_cap=U), log_every=0))
    data = SyntheticCTR(num_users=1_000_000, num_items=200_000,
                        batch_size=batch, seed=0)
    batches = [data.batch() for _ in range(steps + evals)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, times = [], []
    for fb, b in batches[:steps]:
        t0 = time.perf_counter()
        out = trainer.train_step(fb, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(out["loss"])
        assert out["preds"].shape == (batch,)
    ev = trainer.evaluate(iter(batches[steps:]), max_steps=evals)
    torch.cuda.synchronize()
    launches = {"gather_rows": ops.gather_rows.launches,
                "scatter_rows": ops.scatter_rows.launches}
    losses = torch.stack(losses).cpu().numpy()
    assert np.isfinite(losses).all(), f"non-finite losses {losses}"
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["auc"] <= 1.0, ev
    assert launches["gather_rows"] == steps + evals, launches
    assert launches["scatter_rows"] == steps, launches
    log(f"main path: losses {np.round(losses, 5).tolist()}; eval {ev}; "
        f"ms/step {1e3 * np.mean(times[2:]):.3f} (steps 3-{steps}, host "
        f"clock with synchronize; first step {1e3 * times[0]:.1f} ms); "
        f"launches {launches}")
    return launches


def phase_card_vs_cpu():
    """One carried state, 3 steps on the card and on the CPU: losses agree
    to rtol 1e-4 (the card's index-add backward uses atomics in a varying
    order, and its reductions sum in another order than the CPU's)."""
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

    def make(device):
        return Trainer(DeepFMTask(capacity_per_shard=4096, hidden=(32, 16),
                                  init_scale=0.0),
                       TrainerConfig(engine=EngineConfig(unique_cap=512,
                                                         new_cap=512),
                                     log_every=0), device=device)

    data = SyntheticCTR(num_users=400, num_items=300, batch_size=64, seed=11)
    batches = [data.batch() for _ in range(6)]
    cpu = make("cpu")
    for i in range(3):
        cpu.train_step(*batches[i], ts=500 + i)
    card = make("cuda")
    convert.load_state(card, convert.export_state(cpu))
    lc, lg = [], []
    for i in range(3, 6):
        lc.append(cpu.train_step(*batches[i], ts=500 + i)["loss"].item())
        lg.append(card.train_step(*batches[i], ts=500 + i)["loss"].item())
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    log(f"card vs cpu losses: {lg} vs {lc}")


def phase_northstar():
    from monolith_tpu_torch.demo import NORTHSTAR_BAND, northstar
    t0 = time.time()
    r = northstar(device="cuda")
    lo, hi = NORTHSTAR_BAND
    log(f"northstar: {r} in {time.time() - t0:.1f} s")
    assert lo <= r["eval_auc"] <= hi, (r["eval_auc"], NORTHSTAR_BAND)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.time()
    phase_build()
    kernels = phase_kernels()
    launches = phase_main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase_card_vs_cpu()
    phase_northstar()
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
