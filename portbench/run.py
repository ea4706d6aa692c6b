"""One run of one cell of the benchmark of monolith_tpu_torch on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration and its
traffic mix are found by name in BENCHMARK.json; each is a file of its own
under portbench/ (configs/<config>.json, traffic/<traffic>.json), the
traffic names its driver (drivers/<driver>.py), the configuration its
model (models/<model>.py builds the program's task, reference/<model>.py
is the plain reference) and its stream (streams/<stream>.py), and each
per-layer metric is read by metrics/<metric>.py. A cell's limits of the
numbers compared are limits/<cell>.json.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared beside its limit;
the last lines of standard error are the same numbers. Earlier lines of
standard output say what the run saw (the card and its power limit, the
window, launches and ids per step).

A run refuses to start without CUDA or with fewer cards than the cell
asks for, and prints no result if jax, jaxlib, flax, optax or the JAX
package monolith_tpu is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import compare


def _process_start() -> float:
    """When this process started, on the wall clock (/proc; the time this
    module was loaded where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "monolith_tpu")


@dataclasses.dataclass
class Ctx:
    """What a driver needs for one run of one cell."""
    cell: str
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    device_kind: str
    program: object
    reference: object
    stream: object
    log: Callable[[str], None]


def _load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(cell: str) -> Dict:
    """The cell's entry, configuration, traffic and limits, and the
    metrics it reports, from BENCHMARK.json and the files it names."""
    bench = _load_json(ROOT, "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if cell not in wl:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json "
                         f"({sorted(wl)})")
    w = wl[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metrics: List[Dict]) -> List[Dict]:
        return [m for m in metrics if cell in m.get("workloads", [cell])]
    return {"workload": w, "cfg": _load_json(ROOT, conf["file"]),
            "traffic": _load_json(HERE, "traffic", w["traffic"] + ".json"),
            "limits": _load_json(HERE, "limits", cell + ".json"),
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def reader(metric: str):
    """metrics/<metric>.py's `read(record) -> float or None`."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"),
        os.path.join(HERE, "metrics", metric + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that this process may not hold,
    compared whole (monolith_tpu_torch is not monolith_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e!r})"


def context(cell: str, files: Dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", log: Callable[[str], None] = print) -> Ctx:
    cfg, traffic = files["cfg"], files["traffic"]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return Ctx(cell=cell, cfg=cfg, traffic=traffic, seed=seed,
               seconds=seconds, trace=trace, device=dev, device_kind=kind,
               program=importlib.import_module(
                   f"portbench.models.{cfg['model']}"),
               reference=importlib.import_module(
                   f"portbench.reference.{cfg['model']}"),
               stream=importlib.import_module(
                   f"portbench.streams.{cfg['stream']}"),
               log=lambda s: log("portbench: " + s))


def driver(ctx: Ctx):
    return importlib.import_module(
        f"portbench.drivers.{ctx.traffic['driver']}")


def execute(cell: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", files: Optional[Dict] = None,
            log: Callable[[str], None] = print) -> Dict:
    """Run the cell once and return the result line's object. `files`
    (as `cell_files` returns) may stand in for the files on disk, and
    `device` for the card: the tests run small cells on the CPU."""
    files = files or cell_files(cell)
    ctx = context(cell, files, seed, seconds, trace, device, log)
    dev, kind = ctx.device, ctx.device_kind
    ctx.log(f"{cell}, seed {seed}, {seconds} s, trace {int(trace)}; card "
            f"{kind}; nvidia-smi: {power_limit()}")
    out = driver(ctx).run(ctx)
    metrics = {}
    if trace:
        for m in files["per_layer"]:
            v = reader(m["name"])(out["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["e2e"],
                      setup_s=out["wall_window_start"] - PROCESS_START)
        for m in files["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    readings, limits = out["readings"], files["limits"]
    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": kind, "count": files["workload"]["chips"],
                  "memory_peak_bytes": out["memory_peak_bytes"]}
    finite = all(math.isfinite(m["value"]) for m in metrics.values())
    for m in metrics.values():  # JSON holds no infinity
        m["value"] = m["value"] if math.isfinite(m["value"]) \
            else sys.float_info.max
    result = {"correct": (compare.judge(readings, limits) and finite
                          and out["failed"] == 0),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_out}
    if trace:
        device_out.update(busy_s=out["busy_s"], window_s=out["window_s"])
        if "breakdown" in out:
            result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": readings[k] if math.isfinite(
        readings[k]) else repr(readings[k]), "limit": limits[k]}
        for k in limits}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    files = cell_files(args.workload)
    chips = files["workload"]["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"portbench: needs {chips} CUDA card(s); this machine has "
              f"{cards}: no run", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), files=files)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window: no "
              f"result", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
