#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (monolith_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (it
needs one card and exits non-zero without CUDA). Phases, none of whose
failures is caught:

  1. the card's name and power limit (nvidia-smi);
  2. build the host library (g++) and each kernel library (one nvcc per
     CUDA source, sm_90a) from the checkout's sources, all in parallel;
  3. K1 (gather_rows) and K2 (scatter_rows) against their plain versions at
     each path's shapes (DeepFM: pool [2^21, 128] f32, 32768 rows;
     multislot bf16: pool [17 x 2^18, 128] bf16, 49152 rows; ~10% of rows
     -1), and K3 (stochastic_round_bf16) at [49152, 128] f32: bit-exact;
     each timed (kernel, plain version, one library call) beside its bound,
     by CUDA events around each launch after an L2 flush; beside that the
     event floor (an empty kernel timed the same way);
  4. the DeepFM path: full-width DeepFM (bench.py's deepfm config:
     capacity 2^21, unique_cap 32768, batch 8192, hidden (256, 128, 64))
     through Trainer.train_step for 4 steps and Trainer.evaluate for 1
     batch, with the kernels' launch counts read right after;
  5. the multislot bf16 path: bench.py's multislot config with
     MT_BENCH_DTYPE=bf16 at full width (16 + 1 tables merged into one bf16
     pool of 17 x 2^18 rows, stochastic rounding, 40 slots + a 20-long
     DIN history, bf16 dense tower (256, 128, 64), unique_cap 49152, batch
     8192), 4 train steps and 1 eval batch, launch counts read right
     after;
  5b. the DeepFM block path: the same DeepFM config with
     steps_per_dispatch=8: one train_step, then 3 blocks of 8 through
     stage_block + train_step_block(..., staged=...) in bench.py's order
     (block k+1 staged right after block k is dispatched), then 1 eval
     batch; launch counts K1 = 1 + 24 + 1, K2 = 1 + 24; finite losses
     that agree with phase 4's over the steps both ran (the stream hardly
     repeats an id in 25 steps, so the loss stays at 0.696 and cannot be
     asked to fall); every train_step_block runs with PyTorch's synchronisation
     check set to raise; a staged block dispatched out of turn raises;
  5c. the multislot bf16 asynchronous block path: the same multislot
     config with async_optimize=True, same shape of run; K1 = 1 + 2*24 + 1
     (two gathers a step of a block), K2 = K3 = 1 + 24 (the first step of
     a block has no pending write-back and launches none; the last
     step's lands at the end of its block); finite, falling losses whose
     first two agree with phase 5's;
     both block phases print ms per step of the block path and of the
     per-step path in the same trainer, the host pack per step and the
     upload per block;
  5d. the block on the card against the block on the CPU from one carried
     state: a small DeepFM with its vector segment under DC, clip_norm
     0.05 and init_scale 0.0, synchronous and asynchronous (losses rtol
     1e-4, live pool rows rtol 1e-4 / atol 1e-5), and the small multislot
     bf16 variant, asynchronous (losses rtol 1e-3);
  6. small trainers on the card and on the CPU from one carried state,
     3 steps each: DeepFM f32 losses agree to rtol 1e-4; the multislot
     bf16 variant (bf16 pools, stochastic rounding, bf16 tower) to rtol
     1e-3;
  7. the multislot bf16 bench variant at the JAX package's test size
     trained on the card for 41 steps: train AUC > 0.515;
  8. the port's NORTHSTAR (6000 steps, batch 1024, data seed 7) trained on
     the card: eval AUC inside NORTHSTAR_BAND;
  9. each kernel's own duration from a torch.profiler window over 20
     flushed launches at phase 3's shapes, read by kernel name (last, so
     that no timed phase runs after the profiler has been on).

TF32 is off for matrix products and convolutions (torch.backends), so the
card's f32 dense towers run in full f32 like the CPU's. The second-to-last
line is the kernels' JSON (one entry per kernel and path); the last is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet (bench_rows.py's too)
# peak f32 rate outside the tensor cores (H100 SXM data sheet), the peak
# used for K3's integer operations: a lower bound, as no 32-bit ALU
# operation issues faster
ALU_OPS_PER_S = 67e12
# the multislot bf16 path: pool rows, row width, rows per step
MS_CAP, WIDTH, MS_U = 17 * (1 << 18), 128, 49152


def log(msg):
    print(msg, flush=True)


def kernel_times(fn):
    """A kernel's event times over 20 flushed launches: the mean (`ms`, as
    every other time of the line) and the median, which one slow launch
    does not move."""
    from monolith_tpu_torch.timing import event_times_ms
    times = event_times_ms(fn)
    return {"ms": float(np.mean(times)), "ms_median": float(np.median(times))}


def phase_build():
    from monolith_tpu_torch import build
    results, errors = {}, []

    def run(name, fn):
        try:
            t0 = time.time()
            results[name] = (fn(), time.time() - t0)
        except Exception as e:  # re-raised below, after every build ends
            errors.append(e)

    jobs = [("host", build.build_host_library)] + [
        (f"lib{k}", lambda k=k: build.build_kernel_library(k))
        for k in build.KERNEL_SOURCES]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, (path, secs) in results.items():
        log(f"built {name}: {os.path.relpath(path)} in {secs:.1f} s")
    for k in build.KERNEL_SOURCES:
        log(f"ptxas lib{k}: " + " | ".join(
            ln.strip() for ln in build.build_log(f"lib{k}").splitlines()
            if "registers" in ln or "Compiling" in ln))


def phase_rows(path, floor):
    """K1/K2 at one path's shapes against their plain versions."""
    import torch
    from monolith_tpu_torch.bench_rows import SHAPES, bounds_ms, make_case
    from monolith_tpu_torch.ops import scatter as ops
    from monolith_tpu_torch.timing import time_ms
    cap, width, dtype, u = SHAPES[path]
    pool, rows, values = make_case(cap, width, dtype, u)
    valid = rows >= 0
    n_valid = int(valid.sum())
    row_bytes = width * pool.element_size()
    tname = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    shape = f"pool [{cap},{width}] {tname}, rows [{u}] ({n_valid} valid)"

    out = ops.gather_rows(pool, rows)
    ref = ops.gather_rows_plain(pool, rows)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16)), \
        f"gather_rows differs from its plain version ({shape})"
    gather_err = float((out.float() - ref.float()).abs().max())

    pool_k, pool_p = pool.clone(), pool.clone()
    ops.scatter_rows(pool_k, rows, values)
    ops.scatter_rows_plain(pool_p, rows, values)
    torch.cuda.synchronize()
    assert torch.equal(pool_k.view(torch.int16), pool_p.view(torch.int16)), \
        f"scatter_rows differs from its plain version ({shape})"
    scatter_err = float((pool_k.float() - pool_p.float()).abs().max())
    del pool_p, ref, out

    geometry = ops.kernel_geometry(u, row_bytes)
    tile_rows, smem = ops.tile_geometry(row_bytes)
    assert (geometry["warps"], geometry["stages"], geometry["tile_rows"],
            geometry["smem_bytes"]) == (ops.WARPS, ops.STAGES, tile_rows,
                                        smem), geometry
    grid = ops.grid_size(u, tile_rows, geometry["blocks_per_sm"],
                         geometry["sms"])
    assert geometry["gather_grid"] == geometry["scatter_grid"] == grid, \
        (geometry, grid)

    safe = rows.clamp(min=0).long()
    vrows, vvals = rows[valid].long(), values[valid]
    # K1: rows read + valid pool rows read + every output row written;
    # K2: rows read + valid value rows read + valid pool rows written
    bound1, bound2 = bounds_ms(u, n_valid, row_bytes)
    k1 = {"name": "gather_rows", "path": path, "route": "cuda",
          "source": "monolith_tpu_torch/csrc/rows.cu",
          "replaces": "monolith_tpu/ops/scatter.py:143", "shape": shape,
          "max_abs_err": gather_err,
          **kernel_times(lambda: ops.gather_rows(pool, rows)),
          "plain_ms": time_ms(lambda: ops.gather_rows_plain(pool, rows)),
          "bound_ms": bound1, "bound_by": "bytes",
          "library_ms": time_ms(lambda: torch.index_select(pool, 0, safe))}
    k2 = {"name": "scatter_rows", "path": path, "route": "cuda",
          "source": "monolith_tpu_torch/csrc/rows.cu",
          "replaces": "monolith_tpu/ops/scatter.py:177", "shape": shape,
          "max_abs_err": scatter_err,
          **kernel_times(lambda: ops.scatter_rows(pool_k, rows, values)),
          "plain_ms": time_ms(lambda: ops.scatter_rows_plain(pool_k, rows,
                                                             values)),
          "bound_ms": bound2, "bound_by": "bytes",
          "library_ms": time_ms(lambda: pool_k.index_copy_(0, vrows, vvals))}
    for k in (k1, k2):
        k["event_floor_ms"] = floor
        log(f"{k['name']} [{path}]: bit-exact; {k['ms']:.4f} ms by events "
            f"(median {k['ms_median']:.4f}, floor {floor:.4f}; plain {k['plain_ms']:.4f}, library "
            f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f}); {shape}; "
            f"grid {grid} x {ops.WARPS} warps, {tile_rows} rows a tile, "
            f"{smem} B of shared memory")
    return [k1, k2]


def phase_rounding(path, floor):
    """K3 at the multislot path's shape against its plain version."""
    import torch
    from monolith_tpu_torch.ops import rounding
    from monolith_tpu_torch.timing import time_ms
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((MS_U, WIDTH), generator=g, device="cuda")
    seed = 0x0123456789ABCDEF
    out = rounding.stochastic_round_bf16(x, seed)
    ref = rounding.stochastic_round_bf16_plain(x, seed)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16)), \
        "stochastic_round_bf16 differs from its plain version"
    mean_gap = float((out.float().mean(dtype=torch.float64)
                      - x.mean(dtype=torch.float64)).abs())
    assert mean_gap < 2 ** -10, mean_gap
    n = x.numel()
    # Philox4x32-10 for each 4 elements: 10 rounds of 2 mul-hi, 2 mul-lo,
    # 4 xor and 2 key adds; then an add and two shifts per element
    ops_count = (n // 4) * 10 * 10 + n * 3
    bytes_ms = n * (4 + 2) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / ALU_OPS_PER_S * 1e3
    k3 = {"name": "stochastic_round_bf16", "path": path, "route": "cuda",
          "source": "monolith_tpu_torch/csrc/rounding.cu",
          "replaces": "monolith_tpu/ops/rounding.py:33",
          "shape": f"x [{MS_U},{WIDTH}] f32 -> bf16",
          "max_abs_err": float((out.float() - ref.float()).abs().max()),
          "mean_gap": mean_gap,
          **kernel_times(lambda: rounding.stochastic_round_bf16(x, seed)),
          "event_floor_ms": floor,
          "plain_ms": time_ms(
              lambda: rounding.stochastic_round_bf16_plain(x, seed)),
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
          # round-to-nearest over the same bytes: no PyTorch call rounds
          # stochastically, so this is a yardstick, not the same function
          "library_ms": time_ms(lambda: x.to(torch.bfloat16)),
          "library_call": "x.to(torch.bfloat16) (round to nearest)"}
    log(f"stochastic_round_bf16 [{path}]: bit-exact, mean gap {mean_gap:.3e}; "
        f"{k3['ms']:.4f} ms by events (median {k3['ms_median']:.4f}, floor "
        f"{floor:.4f}; plain "
        f"{k3['plain_ms']:.4f}, x.to(bf16) "
        f"{k3['library_ms']:.4f}, bound {k3['bound_ms']:.4f} by "
        f"{k3['bound_by']}; ops bound {ops_ms:.4f})")
    return [k3]


def phase_kernel_durations(kernels):
    """Each kernel's own duration, by kernel name, from a torch.profiler
    window (CPU + CUDA) over 20 flushed launches at the shapes of phase 3,
    written into its entry as `kernel_ms_profiler` (None where the profiler
    saw no device time). It runs after every timed phase, so that none of
    them runs in a process that has had the profiler on."""
    import torch
    from monolith_tpu_torch.bench_rows import SHAPES, make_case
    from monolith_tpu_torch.ops import rounding
    from monolith_tpu_torch.ops import scatter as ops
    from monolith_tpu_torch.timing import profiler_ms
    calls = {}
    for path in SHAPES:
        pool, rows, values = make_case(*SHAPES[path])
        calls["gather_rows", path] = (
            lambda pool=pool, rows=rows: ops.gather_rows(pool, rows))
        calls["scatter_rows", path] = (
            lambda pool=pool, rows=rows, values=values:
            ops.scatter_rows(pool, rows, values))
    x = torch.randn((MS_U, WIDTH), device="cuda")
    calls["stochastic_round_bf16", "multislot_bf16"] = (
        lambda: rounding.stochastic_round_bf16(x, 1))
    for k in kernels:
        ms = profiler_ms(calls[k["name"], k["path"]], k["name"] + "_kernel")
        k["kernel_ms_profiler"] = ms
        log(f"{k['name']} [{k['path']}]: "
            + ("the profiler saw no device time" if ms is None else
               f"{ms:.4f} ms by the profiler's kernel duration ({k['ms']:.4f} "
               f"by events, floor {k['event_floor_ms']:.4f}, bound "
               f"{k['bound_ms']:.4f})"))


def drive_path(name, trainer, batches, steps, evals, expect):
    """`steps` train steps and `evals` eval batches through the Trainer's
    entry points, with every kernel's launch count set to 0 just before and
    read just after; checks the counts against `expect` and returns them."""
    import torch
    from monolith_tpu_torch import ops
    batch = len(batches[0][1]["label"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, times, uniques = [], [], []
    for fb, b in batches[:steps]:
        t0 = time.perf_counter()
        out = trainer.train_step(fb, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(out["loss"])
        uniques.append(sum(out["stats"]["unique"].values()))
        assert out["preds"].shape == (batch,)
        assert not any(out["stats"]["overflow"].values()), out["stats"]
    ev = trainer.evaluate(iter(batches[steps:]), max_steps=evals)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    losses = torch.stack(losses).cpu().numpy()
    assert np.isfinite(losses).all(), f"non-finite losses {losses}"
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["auc"] <= 1.0, ev
    assert launches == expect, (launches, expect)
    log(f"{name} path: losses {np.round(losses, 5).tolist()}; eval {ev}; "
        f"ms/step {1e3 * np.mean(times[2:]):.3f} (steps 3-{steps}, host "
        f"clock with synchronize; first step {1e3 * times[0]:.1f} ms); "
        f"uniques/step {int(np.mean(uniques))}; launches {launches}")
    return launches, losses


PATH_STEPS, PATH_EVALS = 4, 1   # the per-step path phases
BLOCK_K, BLOCKS = 8, 3          # the block path phases


def phase_deepfm_path():
    """Full-width DeepFM: 4 train steps + 1 eval batch."""
    from monolith_tpu_torch.profile_step import CONFIGS
    steps, evals = PATH_STEPS, PATH_EVALS
    trainer, data = CONFIGS["deepfm"]()
    batches = [data.batch() for _ in range(steps + evals)]
    return drive_path("deepfm_f32", trainer, batches, steps, evals,
                      {"gather_rows": steps + evals, "scatter_rows": steps,
                       "stochastic_round_bf16": 0})  # (launches, losses)


def phase_multislot_path():
    """Full-width multislot bf16 (bench.py:224-242 with
    MT_BENCH_DTYPE=bf16): 4 train steps + 1 eval batch."""
    import torch
    from monolith_tpu_torch.profile_step import CONFIGS
    steps, evals = PATH_STEPS, PATH_EVALS
    trainer, data = CONFIGS["multislot_bf16"]()
    pool = trainer.table_states["table_all"]["data"]
    assert pool.dtype == torch.bfloat16 and tuple(pool.shape) == \
        (MS_CAP, WIDTH), (pool.dtype, pool.shape)
    batches = [data.batch() for _ in range(steps + evals)]
    launches, losses = drive_path(
        "multislot_bf16", trainer, batches, steps, evals,
        {"gather_rows": steps + evals, "scatter_rows": steps,
         "stochastic_round_bf16": steps})
    assert trainer.table_states["table_all"]["data"].dtype == torch.bfloat16
    return launches, losses


def drive_block_path(name, trainer, data, expect, per_step_losses, same,
                     rtol, falling):
    """One train_step, then BLOCKS blocks of BLOCK_K through stage_block +
    train_step_block in bench.py's order, then 1 eval batch, with every
    kernel's launch count set to 0 just before and read just after. Every
    train_step_block runs with PyTorch's synchronisation check set to
    raise, so a host-device synchronisation inside a block fails the
    phase. The losses must be finite, agree over their first `same` steps
    with `per_step_losses` (the per-step path's on the same stream, from a
    trainer of the same seed) to `rtol`, and fall (`falling`: the mean of
    the last block under the mean of the first 8 steps) or, on a stream
    whose ids hardly repeat within 25 steps, stay within 0.01 of where
    they began. Then, outside the counted run: a staged block dispatched out of
    turn must raise; the per-step path's time in the same trainer; the
    host pack and upload costs."""
    import torch
    from monolith_tpu_torch import ops
    from monolith_tpu_torch.profile_step import block_costs, run_blocks
    K, n = BLOCK_K, BLOCK_K * BLOCKS
    batches = [data.batch() for _ in range(1 + n + 1)]
    batch = len(batches[0][1]["label"])
    block = trainer.train_step_block

    def checked_block(pairs, ts=None, staged=None):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return block(pairs, ts=ts, staged=staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    trainer.train_step_block = checked_block
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    first = trainer.train_step(*batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = run_blocks(trainer, batches[1:1 + n], K)
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t0) / n * 1e3
    ev = trainer.evaluate(iter(batches[1 + n:]), max_steps=1)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert launches == expect, (launches, expect)
    assert trainer.step == 1 + n
    for out in outs:
        assert out["loss"].shape == (K,) and out["preds"].shape == (K, batch)
        assert len(out["stats"]) == K
        assert not any(any(st["overflow"].values()) for st in out["stats"])
    losses = torch.cat([first["loss"][None]] + [o["loss"] for o in outs]
                       ).cpu().numpy()
    assert np.isfinite(losses).all(), f"non-finite losses {losses}"
    np.testing.assert_allclose(losses[:same], per_step_losses[:same],
                               rtol=rtol)
    if falling:
        assert losses[-K:].mean() < losses[:K].mean(), \
            f"loss not falling {losses}"
    else:
        assert np.abs(losses - losses[0]).max() < 0.01, \
            f"loss drifting {losses}"
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["auc"] <= 1.0, ev

    # a staged block is only good for the very next dispatch
    more = [data.batch() for _ in range(2 * K + 1)]
    staged = trainer.stage_block(more[:K])
    trainer.train_step(*more[2 * K])
    try:
        trainer.train_step_block(more[:K], staged=staged)
    except ValueError as e:
        assert "not the next dispatch" in str(e), e
    else:
        raise AssertionError("a staged block dispatched out of turn ran")

    # the per-step path in the same trainer, no synchronisation between
    # steps either
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fb, b in more[K:2 * K]:
        trainer.train_step(fb, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / K * 1e3
    pack_ms, upload_ms, nbytes = block_costs(trainer, more[:K], K)
    log(f"{name} block path: losses {np.round(losses, 5).tolist()}; eval "
        f"{ev}; ms/step {block_ms:.3f} over {BLOCKS} blocks of {K} (host "
        f"clock, one synchronize at the end); per-step path in the same "
        f"trainer {step_ms:.3f} ms/step ({K} steps, one synchronize at the "
        f"end); host pack {pack_ms:.3f} ms/step; upload {upload_ms:.3f} "
        f"ms/block ({nbytes} bytes); launches {launches}")
    return launches


def phase_deepfm_block_path(per_step_losses):
    """Full-width DeepFM (bench.py:178-185), steps_per_dispatch=8. Its
    stream (10^6 users, 2 x 10^5 items) hardly repeats an id within 25
    steps of 8192, so the loss stays at its start (0.696) and is held
    against the per-step path's instead of being asked to fall."""
    from monolith_tpu_torch.profile_step import CONFIGS
    trainer, data = CONFIGS["deepfm"](steps_per_dispatch=BLOCK_K)
    n = BLOCK_K * BLOCKS
    return drive_block_path("deepfm_f32", trainer, data,
                            {"gather_rows": 1 + n + 1, "scatter_rows": 1 + n,
                             "stochastic_round_bf16": 0},
                            per_step_losses, same=PATH_STEPS, rtol=1e-4,
                            falling=False)


def phase_multislot_async_block_path(per_step_losses):
    """Full-width multislot bf16 (bench.py:224-242 with MT_BENCH_DTYPE=bf16
    and MT_BENCH_ASYNC=1): the 1-step-stale block. Two K1 launches a step
    of a block (stale, then fresh); one K2 and one K3 a step: the first
    step of a block has no pending write-back and launches none, and the
    last step's lands at the end of its block. The first two steps (the
    single step and the first of a block, which has nothing pending) see
    no staleness and must give the per-step path's losses (rtol 1e-3: bf16
    pools and tower)."""
    from monolith_tpu_torch.profile_step import CONFIGS
    trainer, data = CONFIGS["multislot_bf16"](steps_per_dispatch=BLOCK_K,
                                              async_optimize=True)
    assert trainer.config.engine.async_optimize
    n = BLOCK_K * BLOCKS
    return drive_block_path("multislot_bf16 asynchronous", trainer, data,
                            {"gather_rows": 1 + 2 * n + 1,
                             "scatter_rows": 1 + n,
                             "stochastic_round_bf16": 1 + n},
                            per_step_losses, same=2, rtol=1e-3, falling=True)


def phase_block_card_vs_cpu():
    """One carried state, one block of 4 on the card and on the CPU,
    init_scale=0.0 (the two devices' generators draw different inits),
    clip_norm 0.05, the DeepFM's vector segment under DC(lambda_=50):
    synchronous and asynchronous, on batches that repeat their ids (so
    that the asynchronous forward is stale). The pooling backward's
    atomics forbid bit-exactness on the card: losses rtol 1e-4, live pool
    rows rtol 1e-4 / atol 1e-5. Then the small multislot bf16 variant
    (stochastic rounding, bf16 tower), asynchronous: losses rtol 1e-3."""
    import dataclasses

    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
    from monolith_tpu_torch.embedding import optimizers
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

    class DCDeepFM(DeepFMTask):
        def tables(self):
            t = super().tables()[0]
            vec = t.segments[1]
            vec = dataclasses.replace(vec, optimizer=optimizers.DC(
                learning_rate=vec.optimizer.learning_rate, lambda_=50.0,
                base=vec.optimizer))
            return [dataclasses.replace(t, segments=(t.segments[0], vec))]

    def deepfm(device, stale):
        return Trainer(DCDeepFM(capacity_per_shard=4096, hidden=(32, 16),
                                init_scale=0.0),
                       TrainerConfig(engine=EngineConfig(
                           unique_cap=512, new_cap=512, async_optimize=stale),
                           clip_norm=0.05, log_every=0), device=device)

    def multislot(device, stale):
        return small_multislot(device, async_optimize=stale, clip_norm=0.05,
                               init_scale=0.0)

    rng = np.random.default_rng(11)
    ids = np.arange(200)
    pairs = [({"user_id": rng.choice(ids, (64, 1)).astype(np.int64),
               "item_id": rng.choice(ids, (64, 1)).astype(np.int64),
               "hist_items": rng.choice(ids, (64, 10)).astype(np.int64)},
              {"label": rng.integers(0, 2, 64).astype(np.float32)})
             for _ in range(5)]
    ms_data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                                 history_length=6, batch_size=256, seed=11)
    ms_pairs = [ms_data.batch() for _ in range(5)]
    for name, make, batches, stale, rtol, pools in (
            ("deepfm f32 + DC, synchronous", deepfm, pairs, False, 1e-4, True),
            ("deepfm f32 + DC, asynchronous", deepfm, pairs, True, 1e-4, True),
            ("multislot bf16, asynchronous", multislot, ms_pairs, True, 1e-3,
             False)):
        cpu = make("cpu", stale)
        cpu.train_step(*batches[0], ts=500)
        card = make("cuda", stale)
        convert.load_state(card, convert.export_state(cpu))
        lc = cpu.train_step_block(batches[1:], ts=501)["loss"].numpy()
        lg = card.train_step_block(batches[1:], ts=501)["loss"].cpu().numpy()
        gap = float(np.max(np.abs(lg / lc - 1)))
        log(f"block card vs cpu, {name}: losses {lg.tolist()} vs "
            f"{lc.tolist()}; worst relative gap {gap:.3e}")
        np.testing.assert_allclose(lg, lc, rtol=rtol)
        if pools:
            sc, sg = convert.export_state(cpu), convert.export_state(card)
            for t in sc["tables"]:
                live = np.sort(sc["stores"][t][1])
                np.testing.assert_allclose(sg["tables"][t][0][live],
                                           sc["tables"][t][0][live],
                                           rtol=1e-4, atol=1e-5)
        assert card.step == cpu.step == 5


def phase_card_vs_cpu():
    """DeepFM f32: one carried state, 3 steps on the card and on the CPU:
    losses agree to rtol 1e-4 (the card's index-add backward uses atomics
    in a varying order, and its reductions sum in another order than the
    CPU's)."""
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


def small_multislot(device, async_optimize=False, clip_norm=0.0, **kw):
    """The bench's bf16 variant at the JAX package's test size
    (tests/test_models.py); `kw` goes to the task."""
    import torch
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.multislot import MultiSlotTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    task = MultiSlotTask(**{**dict(
        num_tables=4, num_slots=10, embedding_dim=8, capacity_per_shard=8192,
        history_length=6, hidden=(32,), merge=True,
        table_dtype=torch.bfloat16, stochastic_rounding=True,
        dense_dtype=torch.bfloat16), **kw})
    return Trainer(task, TrainerConfig(engine=EngineConfig(
        unique_cap=2048, new_cap=2048, async_optimize=async_optimize),
        clip_norm=clip_norm, log_every=0), device=device)


def phase_multislot_card_vs_cpu():
    """The small bf16 variant (bf16 pools, stochastic rounding, bf16
    tower): one carried state, 3 steps on the card and on the CPU, with
    init_scale=0.0 (new rows draw their init from the device's generator,
    whose numbers differ between card and CPU). K3 draws the plain
    version's bits, but the pooling backward's atomics and the card's bf16
    matrix products change bits, which can flip a rounding: losses agree
    to rtol 1e-3."""
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
    data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                              history_length=6, batch_size=256, seed=11)
    batches = [data.batch() for _ in range(6)]
    cpu = small_multislot("cpu", init_scale=0.0)
    for i in range(3):
        cpu.train_step(*batches[i], ts=500 + i)
    card = small_multislot("cuda", init_scale=0.0)
    convert.load_state(card, convert.export_state(cpu))
    lc, lg = [], []
    for i in range(3, 6):
        lc.append(cpu.train_step(*batches[i], ts=500 + i)["loss"].item())
        lg.append(card.train_step(*batches[i], ts=500 + i)["loss"].item())
    gap = float(np.max(np.abs(np.array(lg) / np.array(lc) - 1)))
    log(f"multislot bf16 card vs cpu losses: {lg} vs {lc}; worst relative "
        f"gap {gap:.3e}")
    np.testing.assert_allclose(lg, lc, rtol=1e-3)


def phase_multislot_trains():
    """The small bf16 bench variant trained on the card for 41 steps
    reaches the JAX package's AUC bar (tests/test_models.py)."""
    import torch
    from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
    tr = small_multislot("cuda")
    data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                              history_length=6, batch_size=256, seed=1)
    res = tr.train(iter(data), steps=41)
    log(f"multislot bf16 small, 41 steps on the card: {res}")
    assert np.isfinite(res["loss"]) and res["auc"] > 0.515, res
    assert tr.table_states["table_all"]["data"].dtype == torch.bfloat16


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
    from monolith_tpu_torch import timing
    timing.warm_up()
    floor = timing.event_floor_ms()
    log(f"event floor: {floor:.4f} ms (an empty kernel between two events, "
        f"after the L2 flush, as every kernel below is timed)")
    kernels = phase_rows("deepfm_f32", floor)
    kernels += phase_rows("multislot_bf16", floor)
    kernels += phase_rounding("multislot_bf16", floor)
    torch.cuda.empty_cache()
    launches, losses = {}, {}
    launches["deepfm_f32"], losses["deepfm_f32"] = phase_deepfm_path()
    torch.cuda.empty_cache()
    launches["multislot_bf16"], losses["multislot_bf16"] = \
        phase_multislot_path()
    torch.cuda.empty_cache()
    block_launches = {
        "deepfm_f32": phase_deepfm_block_path(losses["deepfm_f32"])}
    torch.cuda.empty_cache()
    block_launches["multislot_bf16"] = phase_multislot_async_block_path(
        losses["multislot_bf16"])
    for k in kernels:
        # each path was driven with the counts set to 0 just before it
        k["launches_by_path"] = {
            "per_step": launches[k["path"]][k["name"]],
            "block": block_launches[k["path"]][k["name"]]}
        k["launches"] = sum(k["launches_by_path"].values())
    torch.cuda.empty_cache()
    phase_block_card_vs_cpu()
    phase_card_vs_cpu()
    phase_multislot_card_vs_cpu()
    phase_multislot_trains()
    phase_northstar()
    torch.cuda.empty_cache()
    phase_kernel_durations(kernels)
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
