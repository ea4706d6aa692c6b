"""The port's config system, metrics and deep-insight clients, training
hooks and failure recovery against the JAX package's, on the CPU.

Config, metrics and deep insight are copies, held exactly: the same argv
gives the same namespace and dataclass in both packages, the same seed the
same sampled records. The hooks run on a small port DeepFM trainer
(`device="cpu"`) beside the JAX trainer on the same seeded batches:
`ThroughputHook`'s example counts (per step and per block of K, where the
JAX hook counts K a block) and `ExchangeMetricsHook`'s metrics must be
equal; checkpoints written by `CheckpointHook` restore in the JAX package;
`TideHook` stops the loop; `ProfilerHook` writes a torch.profiler trace;
`run_with_recovery` restores after an injected failure.
"""

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

from monolith_tpu import config as jconfig
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.estimator import RunnerConfig as JaxRunnerConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training import hooks as jhooks
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu.utils import deep_insight as jdi
from monolith_tpu.utils import metrics_client as jmc
from monolith_tpu_torch import config as pconfig
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.estimator import RunnerConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training import hooks as phooks
from monolith_tpu_torch.training.recovery import run_with_recovery
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
from monolith_tpu_torch.utils import deep_insight as pdi
from monolith_tpu_torch.utils import metrics_client as pmc

torch.set_num_threads(1)

TASK = dict(embedding_dim=8, capacity_per_shard=4096, hidden=(16, 8))
B = 64


def port_trainer(K=1):
    return Trainer(DeepFMTask(**TASK), TrainerConfig(
        engine=EngineConfig(unique_cap=512, new_cap=512), log_every=0,
        steps_per_dispatch=K), device="cpu")


def jax_trainer(K=1):
    return JaxTrainer(JaxDeepFMTask(**TASK), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=512, new_cap=512),
        log_every=0, steps_per_dispatch=K))


def batches(n, seed=71):
    data = SyntheticCTR(num_users=50, num_items=30, batch_size=B, seed=seed)
    return [data.batch() for _ in range(n)]


# ----------------------------------------------------------------------
# config
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mod", [pconfig, jconfig], ids=["port", "jax"])
def test_params_define_set_get_freeze(mod):
    p = mod.Params()
    p.define("lr", 0.1)
    child = mod.Params()
    child.define("dim", 8)
    p.define("model", child)
    p.set(lr=0.5, **{"model.dim": 16})
    assert p.lr == 0.5 and p.get("model.dim") == 16
    assert p.to_dict() == {"lr": 0.5, "model": {"dim": 16}}
    with pytest.raises(AttributeError):
        p.undefined = 1
    with pytest.raises(AttributeError):
        p.define("lr", 0.2)
    q = p.copy()
    p.freeze()
    with pytest.raises(AttributeError):
        p.lr = 0.9
    q.lr = 0.9
    assert q.lr == 0.9 and p.lr == 0.5


def test_instantiable_params():
    class Model:
        def __init__(self, params, extra=0):
            self.dim, self.extra = params.dim, extra

    p = pconfig.InstantiableParams(Model)
    p.define("dim", 32)
    m = p.instantiate(extra=3)
    assert (m.dim, m.extra) == (32, 3)
    with pytest.raises(ValueError):
        pconfig.InstantiableParams().instantiate()


ARGVS = [
    [],
    ["--model_dir", "/tmp/x", "--unique_cap", "32768", "--new_cap", "32768",
     "--steps_per_dispatch", "3", "--log_every", "0"],
    ["--clip_norm", "0.5", "--record_touch", "true", "--seed", "7",
     "--enable_realtime_training", "0", "--save_checkpoints_steps", "10"],
    # CLI flags that are not RunnerConfig fields are ignored, and never
    # prefix-match one (--mode must not become --model_dir)
    ["--mode", "train_and_eval", "--steps", "5", "--task", "deepfm"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_flags_give_the_same_config_in_both_packages(argv):
    ns_p, _ = pconfig.extract_flags(RunnerConfig).parse_known_args(argv)
    ns_j, _ = jconfig.extract_flags(JaxRunnerConfig).parse_known_args(argv)
    assert vars(ns_p) == vars(ns_j)
    cfg = pconfig.parse_into(RunnerConfig, argv)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfig.parse_into(JaxRunnerConfig, argv))
    assert cfg.model_dir != "train_and_eval"


def test_runner_config_fields_and_defaults_equal_jax():
    assert ([(f.name, f.type, f.default)
             for f in dataclasses.fields(RunnerConfig)]
            == [(f.name, f.type, f.default)
                for f in dataclasses.fields(JaxRunnerConfig)])


def test_flags_bridge_types():
    @dataclasses.dataclass
    class Cfg:
        lr: float = 0.1
        steps: int = 10
        name: str = "x"
        flag: bool = False

    cfg = pconfig.parse_into(Cfg, ["--lr", "0.5", "--flag", "true",
                                   "--junk", "1"])
    assert cfg == Cfg(lr=0.5, steps=10, name="x", flag=True)
    assert pconfig.parse_into(Cfg, ["--p_steps", "3"], prefix="p_").steps == 3


# ----------------------------------------------------------------------
# metrics client and deep insight
# ----------------------------------------------------------------------

def test_metric_client(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = pmc.MetricClient(prefix="t", sinks=(pmc.FileMetricSink(path),))
    m.emit_counter("reqs", 1, tags={"ps": "0"})
    m.emit_counter("reqs", 2, tags={"ps": "0"})
    m.emit_store("qsize", 7.0)
    with m.timing("lat"):
        pass
    snap = m.snapshot()
    assert snap["counters"]["t.reqs|ps=0"] == 3
    assert snap["stores"]["t.qsize"] == 7.0
    assert snap["timers"]["t.lat"]["count"] == 1
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["kind"] for ln in lines] == ["counter", "counter", "store",
                                            "timer"]


def test_default_metric_prefix_matches_jax():
    """Dashboards see the same metric names from either package."""
    default = inspect.signature(pmc.get_metric_client).parameters["prefix"]
    assert default.default == inspect.signature(
        jmc.get_metric_client).parameters["prefix"].default == "monolith_tpu"
    assert pmc.get_metric_client().prefix == "monolith_tpu"


@pytest.mark.parametrize("rate,seed", [(1.0, 0), (0.1, 1), (0.3, 5)])
def test_deep_insight_sampling_equals_jax(rate, seed):
    rng = np.random.default_rng(seed)
    labels, preds = rng.integers(0, 2, 500), rng.random(500)
    uids, extra = rng.integers(0, 1000, 500), {"w": rng.random(500)}
    out = []
    for mod in (pdi, jdi):
        c = mod.DeepInsightClient("m", sample_rate=rate, seed=seed)
        n = c.emit(labels, preds, uids=uids, req_time=123, extra=extra)
        assert n == len(c.buffer) == c.emitted
        out.append(c.buffer)
    assert out[0] == out[1]


def test_deep_insight_file_sink(tmp_path):
    path = str(tmp_path / "di.jsonl")
    c = pdi.DeepInsightClient("m", sample_rate=1.0,
                              sink=pdi.JsonFileSink(path))
    c.emit(np.array([1.0, 0.0]), np.array([0.9, 0.2]), req_time=5)
    with open(path) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["label"] for r in recs] == [1.0, 0.0] and not c.buffer


# ----------------------------------------------------------------------
# hooks on a port trainer, against the JAX trainer's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("K,steps,expect", [(1, 6, 5 * B), (3, 9, 2 * 3)])
def test_throughput_hook_counts_equal_jax(K, steps, expect):
    """Per step the hook counts B examples a call; under block dispatch
    preds are [K, B] and the JAX hook counts K a block (its first
    dimension): the port counts the same."""
    data = batches(steps)
    counts = []
    for tr in (port_trainer(K), jax_trainer(K)):
        h = phooks.ThroughputHook(every=10 ** 6, client=pmc.MetricClient()) \
            if isinstance(tr, Trainer) else \
            jhooks.ThroughputHook(every=10 ** 6, client=jmc.MetricClient())
        tr.train(iter(data), steps=steps, hooks=[h])
        counts.append(h._examples)
    assert counts == [expect, expect]


def test_throughput_hook_emits():
    m = pmc.MetricClient()
    port_trainer().train(iter(batches(6)), steps=6,
                         hooks=[phooks.ThroughputHook(every=2, client=m)])
    stores = m.snapshot()["stores"]
    assert {"throughput.examples_per_sec",
            "throughput.steps_per_sec"} <= set(stores)


@pytest.mark.parametrize("K", [1, 2])
def test_exchange_and_machine_metrics_equal_jax(K):
    data = batches(6)
    snaps = []
    for tr, hk, mc in ((port_trainer(K), phooks, pmc),
                       (jax_trainer(K), jhooks, jmc)):
        m = mc.MetricClient()
        tr.train(iter(data), steps=6,
                 hooks=[hk.ExchangeMetricsHook(every=2, client=m),
                        hk.MachineInfoHook(every=2, client=m)])
        snaps.append(m.snapshot()["stores"])
    ex = [{k: v for k, v in s.items() if k.startswith("exchange.")}
          for s in snaps]
    assert ex[0] == ex[1]
    assert {k.split("|")[0] for k in ex[0]} == {
        "exchange.unique", "exchange.new", "exchange.filtered",
        "exchange.new_rejected", "exchange.overflow"}
    assert {"machine.load1", "machine.mem_available_kb"} <= set(snaps[0])
    info = phooks.machine_info()
    assert "ts" in info and info.get("mem_total_kb", 0) > 0


def test_checkpoint_hook_writes_what_jax_restores(tmp_path):
    d = str(tmp_path)
    tr = port_trainer()
    data = batches(8)
    sizes = {}
    tr.train(iter(data[:6]), steps=6, hooks=[
        phooks.CheckpointHook(d, every_steps=2),
        lambda t, out: sizes.setdefault(
            t.step, t.engine.stores["sparse"].size())])
    assert sorted(os.listdir(d)) == ["CHECKPOINT", "ckpt-2", "ckpt-4",
                                     "ckpt-6"]
    assert pckpt.latest_step(d) == 6
    jt = jax_trainer()
    inputs, _ = jt.engine.prepare_batch(data[7][0], ts=0)
    jt._maybe_init(inputs, data[7][1])
    assert jckpt.restore(jt, d, step=4) == 4
    assert jt.engine.stores["sparse"][0].size() == sizes[4]


def test_tide_hook_outside_the_window_stops_the_loop(tmp_path):
    tr = port_trainer()
    h = phooks.TideHook(10, 14, block=False, ckpt_dir=str(tmp_path),
                        clock=lambda: 2 * 3600)  # 02:00 UTC, window 10-14
    tr.train(iter(batches(10)), steps=10, hooks=[h])
    assert tr.step == 1
    assert pckpt.latest_step(str(tmp_path)) == 1


def test_tide_hook_windows():
    phooks.TideHook(10, 14, clock=lambda: 12 * 3600)(None, None)  # no-op
    h = phooks.TideHook(22, 4, clock=lambda: 23 * 3600)
    j = jhooks.TideHook(22, 4, clock=lambda: 23 * 3600)
    for hour in range(24):
        h.clock = j.clock = lambda hour=hour: hour * 3600 + 59
        assert h._in_window() == j._in_window() == (hour >= 22 or hour < 4)


def test_slow_start_hook_waits_and_times_out():
    steps = iter([0, 1, 2, 3, 4, 5])
    h = phooks.SlowStartHook(wait_until_step=3, step_fn=lambda: next(steps),
                             poll_sec=0.0)
    h(None, None)
    assert h.started and next(steps) == 4  # polled 0..3, then started
    h(None, None)  # a no-op once started
    t = phooks.SlowStartHook(wait_until_step=10 ** 9, step_fn=lambda: 0,
                             max_wait_sec=0.0, poll_sec=0.0)
    t(None, None)
    assert t.started


def test_profiler_hook_writes_a_trace(tmp_path):
    tr = port_trainer()
    h = phooks.ProfilerHook(str(tmp_path / "prof"), start_step=2, end_step=4)
    tr.train(iter(batches(6)), steps=6, hooks=[h])
    assert h.trace_path == str(tmp_path / "prof" / "trace-2-4.json")
    with open(h.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_deep_insight_hook_reads_tensors_back():
    rng = np.random.default_rng(3)
    labels, preds = rng.integers(0, 2, 50).astype(np.float32), rng.random(50)
    bufs = []
    for hk, di, out in (
            (phooks, pdi, {"labels": torch.from_numpy(labels),
                           "preds": torch.from_numpy(preds)}),
            (jhooks, jdi, {"labels": labels, "preds": preds})):
        c = di.DeepInsightClient("m", sample_rate=0.5, seed=2)
        hk.DeepInsightHook(c)(None, out)
        hk.DeepInsightHook(c)(None, {"preds": out["preds"]})  # no labels
        bufs.append([{k: v for k, v in r.items() if k != "req_time"}
                     for r in c.buffer])
    assert bufs[0] == bufs[1] and len(bufs[0]) > 10


def test_run_with_recovery_restores_after_an_injected_failure(tmp_path):
    d = str(tmp_path)
    data = batches(6)
    tr = port_trainer()
    tr.train(iter(data[:3]), steps=3)
    pckpt.save(tr, d)
    attempts = []

    def train_fn():
        attempts.append(tr.step)
        if len(attempts) == 1:
            tr.train(iter(data[3:5]), steps=2)
            raise RuntimeError("injected failure")
        return tr.train(iter(data[3:]), steps=3)

    failovers = pmc.get_metric_client().snapshot()["counters"].get(
        "monolith_tpu.worker_failover_cnt", 0)
    res = run_with_recovery(train_fn, trainer=tr, ckpt_dir=d, backoff_s=0.0)
    assert attempts == [3, 3] and tr.step == 6 and "auc" in res
    assert pmc.get_metric_client().snapshot()["counters"][
        "monolith_tpu.worker_failover_cnt"] == failovers + 1
    # the recovered trainer equals one that never failed
    ref = port_trainer()
    ref.train(iter(data), steps=6)
    assert torch.equal(tr.table_states["sparse"]["data"],
                       ref.table_states["sparse"]["data"])
    with pytest.raises(RuntimeError, match="always"):
        run_with_recovery(lambda: (_ for _ in ()).throw(
            RuntimeError("always")), max_retries=1, backoff_s=0.0)
