"""K1/K2 of this checkout against other builds of the same C interface, in
one process on one card.

    python -m monolith_tpu_torch.bench_rows [--other NAME=PATH.cu ...]
                                            [--reps 20]

Builds csrc/rows.cu ("here") and every `--other` source (an earlier
commit's rows.cu, unpacked into a gitignored directory with `git archive`,
or a second design under trial; same `mt_gather_rows` / `mt_scatter_rows`
interface, same nvcc command). At each main path's shapes (chip_smoke.py's:
DeepFM f32, 32768 rows of 512 B from a pool of 2^21; multislot bf16, 49152
rows of 256 B from a pool of 17 x 2^18; multislot f32, 49152 rows of 512 B
from a pool of 17 x 2^18, 2,281,701,376 B, whose last 262,144 rows start
past byte 2^31; ~10% of rows -1) it holds every
build's K1 and K2 bit for bit against the plain versions, then times them
in turns (others, here, here, others reversed), since two processes may
land on two cards: CUDA events around each launch after an L2 flush, and
the kernel's own duration from torch.profiler over the same protocol
(timing.py). It also prints the event floor (an empty kernel between the
events), the bound (bytes over 3.35 TB/s), the library calls
(`index_select`, `index_copy_`), a contiguous copy of as many rows
(`Tensor.copy_`: the same bytes with no index and no scattered row) and the
host's time for one launch call.
Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

from monolith_tpu_torch import build, timing
from monolith_tpu_torch.ops import scatter as ops

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
#: path -> (pool rows, row width in elements, pool dtype, rows per call)
SHAPES = {"deepfm_f32": (1 << 21, 128, torch.float32, 32768),
          "multislot_bf16": (17 * (1 << 18), 128, torch.bfloat16, 49152),
          "multislot_f32": (17 * (1 << 18), 128, torch.float32, 49152)}


def make_case(cap: int, width: int, dtype: torch.dtype, u: int):
    """(pool [cap, width], rows [u] int32 unique with ~10% -1, values
    [u, width]) on the card, from a fixed seed."""
    g = torch.Generator(device="cuda").manual_seed(0)
    pool = torch.randn((cap, width), generator=g, device="cuda").to(dtype)
    rows = torch.randperm(cap, generator=g, device="cuda")[:u].to(torch.int32)
    rows[torch.rand(u, generator=g, device="cuda") < 0.1] = -1
    values = torch.randn((u, width), generator=g, device="cuda").to(dtype)
    return pool, rows, values


def bounds_ms(u: int, n_valid: int, row_bytes: int):
    """(K1's, K2's) least time: K1 reads the indices and the valid pool
    rows and writes every output row; K2 reads the indices and the valid
    value rows and writes the valid pool rows."""
    return ((u * 4 + n_valid * row_bytes + u * row_bytes)
            / HBM_BYTES_PER_S * 1e3,
            (u * 4 + 2 * n_valid * row_bytes) / HBM_BYTES_PER_S * 1e3)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--other", action="append", default=[],
                   metavar="NAME=PATH.cu")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = {}
    for item in args.other:
        name, path = item.split("=", 1)
        lib = ctypes.CDLL(build.build_kernel_library(f"rows_{name}", path))
        ops.declare_rows(lib)
        libs[name] = lib
        print(f"ptxas {name}: " + " | ".join(
            ln.strip() for ln in build.build_log(f"librows_{name}").splitlines()
            if "registers" in ln or "Compiling" in ln), flush=True)
    libs["here"] = ops.kernel_library()
    print("ptxas here: " + " | ".join(
        ln.strip() for ln in build.build_log("librows").splitlines()
        if "registers" in ln or "Compiling" in ln), flush=True)
    others = [n for n in libs if n != "here"]
    turns = others + ["here", "here"] + others[::-1]
    timing.warm_up()
    floor = timing.event_floor_ms(args.reps)
    print(f"event floor {floor} ms", flush=True)
    results, later = [], []
    for path, (cap, width, dtype, u) in SHAPES.items():
        pool, rows, values = make_case(cap, width, dtype, u)
        row_bytes = width * pool.element_size()
        n_valid = int((rows >= 0).sum())
        out = torch.empty_like(values)
        ref = ops.gather_rows_plain(pool, rows)
        pool_p = ops.scatter_rows_plain(pool.clone(), rows, values)
        for name, lib in libs.items():
            out.fill_(1)
            ops.launch_gather(lib, pool, rows, out, row_bytes)
            pool_k = pool.clone()
            ops.launch_scatter(lib, pool_k, rows, values, row_bytes)
            torch.cuda.synchronize()
            assert torch.equal(out.view(torch.int16), ref.view(torch.int16)), \
                f"{name}: gather differs from the plain version ({path})"
            assert torch.equal(pool_k.view(torch.int16),
                               pool_p.view(torch.int16)), \
                f"{name}: scatter differs from the plain version ({path})"
            del pool_k
        del ref, pool_p
        print(f"{path}: every build bit-exact (K1, K2)", flush=True)
        pool_k = pool.clone()
        safe, valid = rows.clamp(min=0).long(), rows >= 0
        vrows, vvals = rows[valid].long(), values[valid]
        calls = {
            "gather_rows": lambda lib, pool=pool, rows=rows, out=out,
            row_bytes=row_bytes: ops.launch_gather(lib, pool, rows, out,
                                                   row_bytes),
            "scatter_rows": lambda lib, pool_k=pool_k, rows=rows,
            values=values, row_bytes=row_bytes: ops.launch_scatter(
                lib, pool_k, rows, values, row_bytes)}
        library = {
            "gather_rows": lambda: torch.index_select(pool, 0, safe),
            "scatter_rows": lambda: pool_k.index_copy_(0, vrows, vvals)}

        # a contiguous copy of as many rows: what the card takes to move
        # these bytes with no index and no scattered row
        def copy(out=out, values=values):
            out.copy_(values)

        for kernel, bound in zip(calls, bounds_ms(u, n_valid, row_bytes)):
            call = calls[kernel]
            ev = {n: [] for n in libs}
            for name in turns:
                ev[name].append(timing.time_ms(
                    lambda: call(libs[name]), args.reps))
            host_us = {}
            for name in libs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):   # few enough not to fill the queue
                    call(libs[name])
                host_us[name] = (time.perf_counter() - t0) / 20 * 1e6
            torch.cuda.synchronize()
            res = {"kernel": kernel, "path": path, "rows": u,
                   "valid": n_valid, "row_bytes": row_bytes,
                   "bound_ms": bound, "event_floor_ms": floor,
                   "library_ms": timing.time_ms(library[kernel], args.reps),
                   "contiguous_copy_ms": timing.time_ms(copy, args.reps),
                   "host_us_per_launch": host_us, "event_ms": ev}
            results.append(res)
            later.append((res, call, copy))
    # The profiler's windows come after every event timing, so that none
    # is taken in a process that has had the profiler on.
    for res, call, copy in later:
        pr = {n: [] for n in libs}
        for name in turns:
            pr[name].append(timing.profiler_ms(
                lambda: call(libs[name]), f"{res['kernel']}_kernel",
                args.reps))
        res["profiler_ms"] = pr
        res["contiguous_copy_profiler_ms"] = timing.profiler_ms(
            copy, "Memcpy DtoD", args.reps)
        print(json.dumps(res), flush=True)
    return results


if __name__ == "__main__":
    main()
