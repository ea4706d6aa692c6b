"""The port's slice as a whole: the DeepFM packed-row train step and eval
of monolith_tpu_torch against the JAX package's Trainer.

A small DeepFMTask (capacity 4096, unique_cap 512, batch 64, hidden
(32, 16)) with init_scale=0.0, so newly admitted rows are zeros in both
packages (their init PRNGs differ). 3 JAX train steps, the whole state
carried across by convert.py, then 3 more steps in each package on the same
batches and timestamps: per-step losses and preds to rtol 1e-5 / atol 1e-6;
dense params, optax accumulators and the live pool rows to atol 1e-5 (f32,
sums in another order). evaluate() on 2 batches gives the same AUC to 1e-6.
"""

import numpy as np
import pytest
import torch

from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

TASK = dict(capacity_per_shard=4096, hidden=(32, 16), init_scale=0.0)
U, B = 512, 64


def _trainers():
    jt = JaxTrainer(JaxDeepFMTask(**TASK), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=U, new_cap=U),
        log_every=0))
    pt = Trainer(DeepFMTask(**TASK), TrainerConfig(
        engine=EngineConfig(unique_cap=U, new_cap=U), log_every=0),
        device="cpu")
    return jt, pt


@pytest.fixture(scope="module")
def run():
    """Both trainers after 3 shared JAX steps + 3 steps each; the per-step
    outputs of the last 3, and 2 eval batches' results."""
    data = SyntheticCTR(num_users=400, num_items=300, batch_size=B, seed=11)
    batches = [data.batch() for _ in range(8)]
    jt, pt = _trainers()
    for i in range(3):
        jt.train_step(*batches[i], ts=500 + i)
    convert.load_state(pt, convert.jax_trainer_state(jt))
    jouts, pouts = [], []
    for i in range(3, 6):
        jo = jt.train_step(*batches[i], ts=500 + i)
        po = pt.train_step(*batches[i], ts=500 + i)
        jouts.append({k: np.asarray(jo[k]) for k in ("loss", "preds")})
        pouts.append({k: po[k].numpy() for k in ("loss", "preds")})
    jev = jt.evaluate(iter(batches[6:8]))
    pev = pt.evaluate(iter(batches[6:8]))
    return jt, pt, jouts, pouts, jev, pev


@pytest.mark.parametrize("step", range(3))
def test_step_loss_and_preds_match_jax(run, step):
    _, _, jouts, pouts, _, _ = run
    for k in ("loss", "preds"):
        np.testing.assert_allclose(pouts[step][k], jouts[step][k],
                                   rtol=1e-5, atol=1e-6)


def test_dense_params_and_accumulators_match_jax(run):
    jt, pt, *_ = run
    jstate = convert.jax_trainer_state(jt)
    pstate = convert.export_state(pt)
    for tree in ("params", "opt_state"):
        ref = convert._to_module_tensors(jstate[tree])
        out = convert._to_module_tensors(pstate[tree])
        assert set(out) == set(ref)
        for name in ref:
            np.testing.assert_allclose(out[name], ref[name], atol=1e-5,
                                       rtol=0, err_msg=f"{tree}/{name}")


def test_live_pool_rows_and_stores_match_jax(run):
    jt, pt, *_ = run
    jstate = convert.jax_trainer_state(jt)
    pstate = convert.export_state(pt)
    jf, jr, _, _ = jstate["stores"]["sparse"]
    pf, pr, _, _ = pstate["stores"]["sparse"]
    np.testing.assert_array_equal(np.sort(pf), np.sort(jf))
    np.testing.assert_array_equal(pr[np.argsort(pf)], jr[np.argsort(jf)])
    live = np.sort(jr)
    np.testing.assert_allclose(pstate["tables"]["sparse"][0][live],
                               jstate["tables"]["sparse"][0][live],
                               atol=1e-5, rtol=0)
    assert pt.step == jt.step == 6


def test_evaluate_auc_matches_jax(run):
    *_, jev, pev = run
    assert abs(pev["auc"] - jev["auc"]) <= 1e-6
    np.testing.assert_allclose(pev["loss"], jev["loss"], rtol=1e-5)


def test_train_loop_drains_device_metrics():
    """train() accumulates loss/AUC on the device and drains them once."""
    _, pt = _trainers()
    data = SyntheticCTR(num_users=400, num_items=300, batch_size=B, seed=3)
    res = pt.train(iter(data), steps=4)
    assert pt.step == 4
    assert pt.loss_mean.count == 4
    assert np.isfinite(res["loss"]) and 0.0 <= res["auc"] <= 1.0
    assert pt._dev_metrics is None


def test_train_reads_exactly_steps_batches():
    """Fault R10 of the reference, pinned: the JAX trainer's per-step
    loop reads batch `steps + 1` from the caller's iterator and drops it
    (its block loop reads `steps`). The port's one loop reads exactly
    `steps` batches, in groups of one and in blocks, and leaves the rest
    to the caller."""
    data = SyntheticCTR(num_users=400, num_items=300, batch_size=B, seed=6)
    batches = [data.batch() for _ in range(6)]
    jt, pt = _trainers()
    rest = iter(batches)
    jt.train(rest, steps=3)
    assert jt.step == 3 and next(rest) is batches[4]
    for K in (1, 4):
        _, pt = _trainers()
        pt.config.steps_per_dispatch = K
        rest = iter(batches)
        pt.train(rest, steps=3)
        assert pt.step == 3 and next(rest) is batches[3]


def test_export_load_roundtrip_between_port_trainers():
    """A state moves between two port trainers (as card <-> CPU does) and
    the next step then agrees."""
    data = SyntheticCTR(num_users=400, num_items=300, batch_size=B, seed=4)
    batches = [data.batch() for _ in range(3)]
    _, a = _trainers()
    for i in range(2):
        a.train_step(*batches[i], ts=10 + i)
    _, b = _trainers()
    convert.load_state(b, convert.export_state(a))
    la = a.train_step(*batches[2], ts=12)["loss"].item()
    lb = b.train_step(*batches[2], ts=12)["loss"].item()
    assert la == lb


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(DeepFMTask(**TASK))


# ----------------------------------------------------------------------
# a task without "label" whose predictions are a dict
# ----------------------------------------------------------------------

def _labelless(base):
    """DeepFM whose batch carries "labels" (no "label") and whose
    predictions are a dict, in either package: metrics accumulate the loss
    alone."""
    if base is JaxDeepFMTask:
        import jax
        from monolith_tpu.losses.losses import bce_with_logits as bce
        sigmoid = jax.nn.sigmoid
    else:
        from monolith_tpu_torch.losses.losses import bce_with_logits as bce
        sigmoid = torch.sigmoid

    class Labelless(base):
        def loss(self, outputs, batch):
            return bce(outputs["logits"], batch["labels"]), {}

        def predictions(self, outputs):
            return {"ctr": sigmoid(outputs["logits"]),
                    "logit": outputs["logits"]}

    return Labelless(**TASK)


@pytest.mark.parametrize("K", [1, 4])
def test_a_labelless_task_trains_with_metrics_like_jax(K):
    """With metrics on (the default), per step and in blocks of 4: the loss
    mean equals the JAX trainer's over the same 9 batches, and the AUC
    histograms stay empty; a block's predictions are stacked key by key."""
    data = SyntheticCTR(num_users=400, num_items=300, batch_size=B, seed=12)
    pairs = [(fb, {"labels": b["label"]}) for fb, b in
             (data.batch() for _ in range(9))]
    jt = JaxTrainer(_labelless(JaxDeepFMTask), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=U, new_cap=U),
        log_every=0, steps_per_dispatch=K))
    inputs, _ = jt.engine.prepare_batch(pairs[0][0], ts=0)
    jt._maybe_init(inputs, pairs[0][1])
    jt.engine.stores["sparse"][0].restore(np.empty(0, np.int64),
                                          np.empty(0, np.int32))
    pt = Trainer(_labelless(DeepFMTask), convert.port_trainer_config(
        jt.config), device="cpu")
    convert.load_state(pt, convert.jax_trainer_state(jt))
    assert pt.config.metrics_enabled
    outs = []
    jr = jt.train(iter(pairs), steps=9)
    pr = pt.train(iter(pairs), steps=9,
                  hooks=[lambda t, out: outs.append(out["preds"])])
    assert pt.loss_mean.count == jt.loss_mean.count == 9
    np.testing.assert_allclose(pr["loss"], jr["loss"], rtol=1e-5)
    assert pr["auc"] == jr["auc"] == 0.5
    assert pt.auc.pos_hist.sum() == pt.auc.neg_hist.sum() == 0
    assert set(outs[0]) == {"ctr", "logit"}
    assert tuple(outs[0]["ctr"].shape) == ((K, B) if K > 1 else (B,))


def test_streaming_metrics_weights_and_resets_match_jax():
    from monolith_tpu import metrics as jm
    from monolith_tpu_torch import metrics as pm
    rng = np.random.default_rng(4)
    preds, labels = rng.random(50), rng.integers(0, 2, 50)
    weights = rng.random(50)
    ja, pa = jm.StreamingAUC(), pm.StreamingAUC()
    ja.update(preds, labels, weights=weights)
    pa.update(preds, labels, weights=weights)
    np.testing.assert_array_equal(pa.pos_hist, ja.pos_hist)
    np.testing.assert_array_equal(pa.neg_hist, ja.neg_hist)
    assert pa.result() == ja.result()
    pa.reset()
    assert pa.result() == 0.5 and not pa.pos_hist.any()
    mean = pm.StreamingMean()
    mean.update(3.0, weight=2.0)
    mean.reset()
    assert mean.result() == 0.0 and mean.count == 0.0
