"""K3 of this checkout against other builds of the same C interface, in one
process on one card.

    python -m monolith_tpu_torch.bench_rounding [--other NAME=PATH.cu ...]
                                                [--reps 20]

Builds csrc/rounding.cu ("here"), the earlier one-group design kept as a
baseline (csrc/baselines/rounding_one_group.cu, "one_group") and every
`--other` source (a variant under trial, or an earlier commit's
rounding.cu unpacked into a gitignored directory; same
`mt_stochastic_round_bf16` interface, same nvcc command). At each of K3's
shapes on the main paths (`SHAPES`: the packed multislot bf16 step's
[49152, 128], the multi-array step's [135040, 128], the
structure-of-arrays step's [49152, 17] and a ragged [13, 17]) it holds
every build bit for bit against the plain version, then times them in
turns (others, one_group, here, here, one_group, others reversed):
CUDA events around each launch after an L2 flush, and the kernel's own
duration from torch.profiler over the same protocol (timing.py). Beside
them: the event floor, an empty kernel on this checkout's grid for the
same n (events and profiler), the bound and `x.to(torch.bfloat16)`, a
round to nearest over the same bytes (no PyTorch call rounds
stochastically). The profiler's readings are taken twice: after the
protocol's flush, which leaves the L2 full of dirty lines, and after a
flush that reads (clean lines). One JSON line a shape.
Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from typing import Dict, Tuple

import torch

from monolith_tpu_torch import build, timing
from monolith_tpu_torch.ops import rounding

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# peak f32 rate outside the tensor cores (H100 SXM data sheet), the peak
# used for K3's integer operations: a lower bound, as no 32-bit ALU
# operation issues faster
ALU_OPS_PER_S = 67e12
#: path -> the shape K3 rounds there
SHAPES = {"multislot_bf16": (49152, 128), "multi_array": (135040, 128),
          "soa": (49152, 17), "ragged": (13, 17)}
BASELINE = "one_group"
BASELINE_SRC = os.path.join(build.CSRC_DIR, "baselines",
                            "rounding_one_group.cu")
SEED = 0x0123456789ABCDEF


def bounds_ms(n: int) -> Tuple[float, float]:
    """(bytes, operations) least times for n elements: 4 B read and 2 B
    written an element; Philox4x32-10 for each 4 elements (10 rounds of 2
    mul-hi, 2 mul-lo, 4 xor and 2 key adds), then an add and two shifts an
    element."""
    ops = (n // 4) * 10 * 10 + n * 3
    return (n * (4 + 2) / HBM_BYTES_PER_S * 1e3,
            ops / ALU_OPS_PER_S * 1e3)


def build_other(name: str, src: str) -> ctypes.CDLL:
    """lib<rounding_name>.so from `src`, a source with K3's C interface."""
    lib = ctypes.CDLL(build.build_kernel_library(f"rounding_{name}", src))
    rounding.declare_rounding(lib)
    return lib


def baseline_library() -> ctypes.CDLL:
    """The earlier one-group design, built as librounding_one_group."""
    return build_other(BASELINE, BASELINE_SRC)


def ptxas_line(name: str) -> str:
    """The registers and spills ptxas reported for lib<name>."""
    return " | ".join(ln.strip() for ln in build.build_log(name).splitlines()
                      if "registers" in ln or "spill" in ln)


def empty_launch(n: int) -> None:
    """An empty kernel on the grid that n elements launch."""
    err = rounding.kernel_library().mt_stochastic_round_bf16_empty(
        n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mt_stochastic_round_bf16_empty: launch failed "
                           f"(CUDA error {err})")


def check_builds(libs: Dict[str, ctypes.CDLL], x: torch.Tensor,
                 seed: int = SEED) -> None:
    """Every build's output equals the plain version's, bit for bit."""
    ref = rounding.stochastic_round_bf16_plain(x, seed).view(torch.int16)
    for name, lib in libs.items():
        out = torch.full(x.shape, -1, dtype=torch.int16,
                         device=x.device).view(torch.bfloat16)
        rounding.launch(lib, x, seed, out)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), ref), \
            f"{name}: stochastic_round_bf16 differs from the plain version " \
            f"at {tuple(x.shape)}"


def time_in_turns(libs: Dict[str, ctypes.CDLL], x: torch.Tensor,
                  reps: int = 20, profiler: bool = False,
                  flush: str = "write", seed: int = SEED) -> Dict[str, list]:
    """Each build's mean time over `reps` flushed launches, in turns
    (the others, here, here, the others reversed): by events, or by the
    profiler's kernel duration; `flush` as timing.py's."""
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    others = [n for n in libs if n != "here"]
    times = {n: [] for n in libs}
    for name in others + ["here", "here"] + others[::-1]:
        def call(lib=libs[name]):
            rounding.launch(lib, x, seed, out)
        times[name].append(
            timing.profiler_ms(call, "stochastic_round_bf16_kernel", reps,
                               flush)
            if profiler else timing.time_ms(call, reps, flush))
    return times


#: the two flushes of timing.py: "write" (the protocol's: the L2 is left
#: full of dirty lines) and "read" (clean lines)
FLUSHES = ("write", "read")


def profiler_readings(libs: Dict[str, ctypes.CDLL], x: torch.Tensor,
                      flush: str, reps: int = 20,
                      seed: int = SEED) -> Dict[str, object]:
    """By the profiler after `flush`: each build in turns, an empty kernel
    on this checkout's grid for x.numel() and x.to(torch.bfloat16)."""
    n = x.numel()
    return {**time_in_turns(libs, x, reps, profiler=True, flush=flush,
                            seed=seed),
            "empty_grid": timing.profiler_ms(
                lambda: empty_launch(n), "stochastic_round_bf16_empty_kernel",
                reps, flush),
            "to_bf16": timing.profiler_ms(lambda: x.to(torch.bfloat16),
                                          "copy_kernel", reps, flush)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--other", action="append", default=[],
                   metavar="NAME=PATH.cu")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = {name: build_other(name, path) for name, path in
            (item.split("=", 1) for item in args.other)}
    libs[BASELINE] = baseline_library()
    libs["here"] = rounding.kernel_library()
    for name in libs:
        lib_name = "librounding" if name == "here" else f"librounding_{name}"
        print(f"ptxas {name}: {ptxas_line(lib_name)}", flush=True)
    timing.warm_up()
    floor = timing.event_floor_ms(args.reps)
    print(f"event floor {floor} ms", flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = {path: torch.randn(shape, generator=g, device="cuda")
             for path, shape in SHAPES.items()}
    results = []
    for path, x in cases.items():
        check_builds(libs, x)
        n = x.numel()
        bytes_ms, ops_ms = bounds_ms(n)
        results.append({
            "path": path, "shape": list(x.shape),
            "geometry": rounding.kernel_geometry(n),
            "bound_ms": max(bytes_ms, ops_ms), "ops_bound_ms": ops_ms,
            "event_floor_ms": floor,
            "event_ms": time_in_turns(libs, x, args.reps),
            "empty_grid_event_ms": timing.time_ms(
                lambda n=n: empty_launch(n), args.reps),
            "to_bf16_ms": timing.time_ms(lambda x=x: x.to(torch.bfloat16),
                                         args.reps)})
        print(f"{path}: every build bit-exact at {tuple(x.shape)}",
              flush=True)
    # The profiler's windows come after every event timing, so that none
    # is taken in a process that has had the profiler on; each after the
    # protocol's flush and after one that reads: the difference is what
    # writing back the flush's dirty lines costs.
    for res, x in zip(results, cases.values()):
        res["profiler_ms"] = {flush: profiler_readings(libs, x, flush,
                                                       args.reps)
                              for flush in FLUSHES}
        print(json.dumps(res), flush=True)
    return results


if __name__ == "__main__":
    main()
