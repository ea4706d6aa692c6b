"""The model zoo of the port (FFM, DIN, DIEN, MMoE, DCN, AutoInt) against
the JAX package's, on the CPU, through the port's entry points.

For each of the six variants (DIN and DIEN are one task, `seq_encoder`
"din" or "dien"), at small widths (capacity 4096, unique_cap 512, batch
64, 80 users x 40 items, inputs made from a seed with numpy):

- carried steps: 3 JAX train steps, the whole state carried into the port
  by convert.py, then 3 steps in each package on batches whose ids the
  first 3 had admitted (so that neither package draws a new row's init:
  their PRNGs differ): losses, predictions and MMoE's per-task losses to
  rtol 1e-5 / atol 1e-6, dense parameters, accumulators and the live pool
  rows to rtol 1e-5 / atol 1e-6 (f32 sums in another order);
- checkpoints: what either package saves after those steps restores in the
  other exactly;
- serving: an export of either package served by both packages'
  `ServingModel`s, predictions to rtol 1e-5 / atol 1e-6, and equal to the
  trainer's eval predictions to rtol 1e-4 / atol 1e-5 (the JAX serving
  test's bar);
- learning: tests/test_models.py's criteria at its sizes, on the port
  alone (the mean loss of the last steps below that of the first, DIN's
  eval AUC above 0.53, MMoE's per-task losses in `aux`);
- the CLI: `python -m monolith_tpu_torch.train --cpu --task <name>
  --steps 3` prints the JAX CLI's JSON keys (`Trainer.train`'s, the same
  for every task of the JAX zoo, read from one JAX CLI run).

MMoE's labels: a batch with `labels` [B, 2] trains both heads on their own
columns; a batch without them falls back to `label` for both heads, as the
JAX task's clamped index does (pinned in both packages below).
"""

import dataclasses
import importlib
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from monolith_tpu import train as jcli
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models import autoint as jautoint
from monolith_tpu.models import dcn as jdcn
from monolith_tpu.models import din as jdin
from monolith_tpu.models import ffm as jffm
from monolith_tpu.models import multitask as jmultitask
from monolith_tpu.serving import ServingModel as JaxServingModel
from monolith_tpu.serving import export_model as jax_export_model
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch import train as pcli
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models import (AutoIntTask, DCNTask, DINTask,
                                       FFMTask, MMoETask)
from monolith_tpu_torch.serving import ServingModel, export_model
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
U, B = 512, 64
SMALL = dict(capacity_per_shard=4096)

#: variant -> (JAX task class, port task class, task kwargs)
VARIANTS = {
    "ffm": (jffm.FFMTask, FFMTask, SMALL),
    "din": (jdin.DINTask, DINTask, dict(SMALL, embedding_dim=8,
                                        hidden=(32, 16))),
    "dien": (jdin.DINTask, DINTask, dict(SMALL, embedding_dim=8,
                                         hidden=(16,), seq_encoder="dien")),
    "mmoe": (jmultitask.MMoETask, MMoETask, SMALL),
    "dcn": (jdcn.DCNTask, DCNTask, SMALL),
    "autoint": (jautoint.AutoIntTask, AutoIntTask, SMALL),
}


def jax_trainer(name, seed=0):
    jcls, _, kw = VARIANTS[name]
    return JaxTrainer(jcls(**kw), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=U, new_cap=U),
        log_every=0, seed=seed))


def port_trainer(name, seed=0):
    _, pcls, kw = VARIANTS[name]
    return Trainer(pcls(**kw), TrainerConfig(
        engine=EngineConfig(unique_cap=U, new_cap=U), log_every=0,
        seed=seed), device="cpu")


def with_labels(name, pair):
    """MMoE's batches carry a second head's labels, as tests/test_models.py
    gives them."""
    fb, b = pair
    if name == "mmoe":
        b = dict(b, labels=np.stack([b["label"], 1.0 - b["label"]], axis=1))
    return fb, b


def batches(name, n, seed=7):
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=B, seed=seed)
    return [with_labels(name, data.batch()) for _ in range(n)]


def seen_again(name, pairs, seed):
    """The same ids in other pairings, with new labels: no id is new to a
    trainer that has stepped through `pairs`."""
    rng = np.random.default_rng(seed)
    out = []
    for fb, b in pairs:
        fb = {k: np.roll(v, i + 1, axis=0)
              for i, (k, v) in enumerate(sorted(fb.items()))}
        b = dict(b, label=rng.integers(0, 2, B).astype(np.float32))
        out.append(with_labels(name, (fb, b)))
    return out


def assert_states_close(got, want, rtol=RTOL, atol=ATOL):
    """Dense trees and the live rows of the pools (the stores' rows)."""
    for tree in ("params", "opt_state"):
        x, y = (convert._to_module_tensors(s[tree]) for s in (got, want))
        assert sorted(x) == sorted(y)
        for k in y:
            np.testing.assert_allclose(x[k], y[k], rtol=rtol, atol=atol,
                                       err_msg=f"{tree}/{k}")
    for t, pool in want["tables"].items():
        live = np.sort(want["stores"][t][1])
        np.testing.assert_array_equal(np.sort(got["stores"][t][1]), live)
        pool = np.asarray(pool).reshape(-1, np.shape(pool)[-1])
        mine = np.asarray(got["tables"][t]).reshape(pool.shape)
        np.testing.assert_allclose(mine[live], pool[live], rtol=rtol,
                                   atol=atol, err_msg=t)


def assert_states_equal(got, want):
    """Two states in convert.py's format, exactly; stores in fid order."""
    for tree in ("params", "opt_state"):
        x, y = (convert._to_module_tensors(s[tree]) for s in (got, want))
        assert sorted(x) == sorted(y)
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    for t in want["tables"]:
        np.testing.assert_array_equal(
            np.asarray(got["tables"][t]).reshape(np.shape(want["tables"][t])),
            want["tables"][t], err_msg=t)
        sa, sb = got["stores"][t], want["stores"][t]
        oa, ob = np.argsort(sa[0]), np.argsort(sb[0])
        for col_a, col_b in zip(sa, sb):
            np.testing.assert_array_equal(col_a[oa], col_b[ob])
    assert got["step"] == want["step"]


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def carried(request):
    """Both trainers after 3 JAX steps carried into the port and 3 steps
    in each; the last 3 steps' outputs of both."""
    name = request.param
    pairs = batches(name, 3)
    jt, pt = jax_trainer(name), port_trainer(name, seed=5)
    for i, p in enumerate(pairs):
        jt.train_step(*p, ts=100 + i)
    convert.load_state(pt, convert.jax_trainer_state(jt))
    outs = []
    for k, p in enumerate(seen_again(name, pairs, seed=1)):
        jo = jt.train_step(*p, ts=200 + k)
        po = pt.train_step(*p, ts=200 + k)
        assert not any(po["stats"]["new"].values())
        outs.append((jo, po))
    return name, jt, pt, pairs, outs


def test_carried_steps_match_jax(carried):
    name, _, _, _, outs = carried
    for jo, po in outs:
        for k in ("loss", "preds"):
            np.testing.assert_allclose(po[k].numpy(), np.asarray(jo[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert sorted(po["aux"]) == sorted(jo["aux"])
        for k in jo["aux"]:
            np.testing.assert_allclose(po["aux"][k].numpy(),
                                       np.asarray(jo["aux"][k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    if name == "mmoe":
        assert sorted(outs[0][1]["aux"]) == ["loss_task0", "loss_task1"]


def test_carried_state_matches_jax(carried):
    _, jt, pt, _, _ = carried
    assert pt.step == int(jt.step) == 6
    assert_states_close(convert.export_state(pt),
                        convert.jax_trainer_state(jt))


def test_checkpoints_cross_the_packages_exactly(carried, tmp_path):
    name, jt, pt, pairs, _ = carried
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jt, jdir)
    pckpt.save(pt, pdir)
    port_reader = port_trainer(name, seed=9)
    assert pckpt.restore(port_reader, jdir) == 6
    assert_states_equal(convert.export_state(port_reader),
                        convert.jax_trainer_state(jt))
    jax_reader = jax_trainer(name, seed=9)
    inputs, _ = jax_reader.engine.prepare_batch(pairs[0][0], ts=0)
    jax_reader._maybe_init(inputs, pairs[0][1])
    assert jckpt.restore(jax_reader, pdir) == 6
    assert_states_equal(convert.jax_trainer_state(jax_reader),
                        convert.export_state(pt))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exports_serve_alike_in_both_packages(carried, tmp_path, writer):
    name, jt, pt, _, _ = carried
    jcls, pcls, kw = VARIANTS[name]
    path = (jax_export_model(jt, str(tmp_path)) if writer == "jax" else
            export_model(pt, str(tmp_path)))
    jmodel = JaxServingModel(jcls(**kw), path, unique_cap=U)
    pmodel = ServingModel(pcls(**kw), path, unique_cap=U, device="cpu")
    assert pmodel.table_sizes() == jmodel.table_sizes()
    for fb, b in batches(name, 2, seed=8):
        got = pmodel.predict(fb, b)
        assert got.shape == (B,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, jmodel.predict(fb, b), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got, pt.predict(fb, b).numpy(),
                                   rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# learning, at tests/test_models.py's sizes and to its criteria
# ----------------------------------------------------------------------

def _learn_trainer(task, cap=1024):
    return Trainer(task, TrainerConfig(
        engine=EngineConfig(unique_cap=cap, new_cap=cap), log_every=0),
        device="cpu")


def _losses(trainer, data, steps, labels=False):
    it, losses = iter(data), []
    for _ in range(steps):
        fb, b = next(it)
        if labels:
            b = dict(b, labels=np.stack([b["label"], 1.0 - b["label"]], 1))
        out = trainer.train_step(fb, b)
        losses.append(float(out["loss"]))
        if labels:
            assert "loss_task0" in out["aux"]
    assert np.isfinite(losses).all()
    return losses


@pytest.mark.parametrize("name,seed", [("ffm", 31), ("dcn", 33),
                                       ("autoint", 34), ("dien", 35)])
def test_loss_falls(name, seed):
    task = {"ffm": lambda: FFMTask(capacity_per_shard=8192),
            "dcn": lambda: DCNTask(capacity_per_shard=8192),
            "autoint": lambda: AutoIntTask(capacity_per_shard=8192),
            "dien": lambda: DINTask(embedding_dim=8, capacity_per_shard=8192,
                                    hidden=(16,), seq_encoder="dien")}[name]()
    data = SyntheticCTR(num_users=100, num_items=60, batch_size=256,
                        seed=seed)
    losses = _losses(_learn_trainer(task), data, 80)
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_mmoe_multitask_trains():
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=128, seed=32)
    trainer = _learn_trainer(MMoETask(capacity_per_shard=8192, num_tasks=2))
    losses = _losses(trainer, data, 40, labels=True)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_din_task_learns():
    task = DINTask(embedding_dim=8, capacity_per_shard=4096, hidden=(32, 16))
    trainer = _learn_trainer(task)
    data = SyntheticCTR(num_users=100, num_items=60, batch_size=256, seed=21)
    _losses(trainer, data, 90)
    ev = trainer.evaluate(iter(SyntheticCTR(num_users=100, num_items=60,
                                            batch_size=256, seed=21)),
                          max_steps=10)
    assert ev["auc"] > 0.53, ev


def test_dien_encoder_runs_on_a_shorter_history():
    task = DINTask(embedding_dim=8, capacity_per_shard=2048, hidden=(16,),
                   seq_encoder="dien", history_length=6)
    trainer = _learn_trainer(task, cap=512)
    fb, b = SyntheticCTR(num_users=50, num_items=30, batch_size=128,
                         seed=3).batch()
    fb = {k: (v[:, :6] if k == "hist_items" else v) for k, v in fb.items()}
    assert np.isfinite(float(trainer.train_step(fb, b)["loss"]))


# ----------------------------------------------------------------------
# MMoE's label clamp, pinned in both packages
# ----------------------------------------------------------------------

def test_mmoe_without_labels_trains_both_heads_on_label():
    import jax.numpy as jnp
    from monolith_tpu.losses import bce_with_logits as jbce
    rng = np.random.default_rng(40)
    logits = rng.normal(size=(16, 2)).astype(np.float32)
    label = rng.integers(0, 2, 16).astype(np.float32)
    jloss, jaux = jmultitask.MMoETask().loss(
        {"task_logits": jnp.asarray(logits), "logits": jnp.asarray(
            logits[:, 0])}, {"label": jnp.asarray(label)})
    ploss, paux = MMoETask().loss(
        {"task_logits": torch.from_numpy(logits),
         "logits": torch.from_numpy(logits[:, 0])},
        {"label": torch.from_numpy(label)})
    want = [float(jbce(jnp.asarray(logits[:, t]), jnp.asarray(label)))
            for t in range(2)]
    for aux in (jaux, paux):
        np.testing.assert_allclose([float(aux["loss_task0"]),
                                    float(aux["loss_task1"])], want,
                                   rtol=1e-6)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(ploss), sum(want), rtol=1e-6)


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

def run_cli(cli, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_cli_keys():
    out = run_cli(jcli, ["--task", "ffm", "--steps", "3", "--batch_size",
                         "128", "--log_every", "0", "--cpu"])
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_cli_trains_the_zoo_task(name, jax_cli_keys):
    task, args = (("din", {"seq_encoder": "dien"}) if name == "dien"
                  else (name, {}))
    out = run_cli(pcli, ["--task", task, "--task_args", json.dumps(args),
                         "--steps", "3", "--log_every", "0", "--cpu"])
    assert {k: sorted(v) for k, v in out.items()} == jax_cli_keys
    assert np.isfinite(out["train"]["loss"])


def test_zoo_tasks_mirror_the_jax_tasks():
    for name in ("ffm", "din", "mmoe", "dcn", "autoint"):
        jmod, jcls = jcli.ZOO[name]
        task = pcli.build_task(name, {})
        names = {f.name for f in dataclasses.fields(task)}
        jtask = getattr(importlib.import_module(jmod), jcls)
        assert names == {f.name for f in dataclasses.fields(jtask)}, name
        assert ([(f.name, f.table, f.max_length, f.combiner)
                 for f in task.features()]
                == [(f.name, f.table, f.max_length, f.combiner)
                    for f in jtask().features()])
