"""The result line: its keys, its metrics by cell, and a run that finds
no card."""

import json
import os
import sys

import pytest

from portbench import run
from portbench.tests import small

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    cell = small.CELL
    r = small.execute(cell, trace=trace)
    keys = list(r)
    assert keys[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    files = run.cell_files(cell)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in files[kind]}
    assert set(r["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == names and "setup_s" in names
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r, allow_nan=False)


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = run.main(["--workload", small.CELL, "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "monolith_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert run.forbidden_modules() == ["jaxlib"]


def test_benchmark_names_its_files():
    b = _bench()
    configs = {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "limits", w["name"] + ".json"))
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "metrics", m["name"] + ".py"))
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
