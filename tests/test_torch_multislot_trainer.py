"""The multislot slice as a whole: monolith_tpu_torch's Trainer on a small
MultiSlotTask (merged tables, DIN, "firstn" history) against the JAX
package's Trainer, with f32 pools and with bf16 pools.

Config: MultiSlotTask(num_tables=4, num_slots=10, embedding_dim=8,
capacity_per_shard=8192, history_length=6, hidden=(32,), merge=True,
init_scale=0.0), unique_cap 2048, batch 256. init_scale=0.0 makes new rows
zeros in both packages (their init PRNGs differ), and stochastic rounding
is off (its noise differs too), so the two can be held step by step: 3 JAX
steps, the whole state carried across by convert.py, then 3 more steps in
each package on the same batches and timestamps.

- f32 pools: losses and preds to rtol 1e-5 (f32 sums in another order).
- bf16 pools (round to nearest): losses to rtol 1e-4, and the live pool
  rows within one bf16 ulp: the f32 row math differs in its last bits, and
  that can move a value across a bf16 rounding boundary.

convert.py's bf16 handling is held here too: a JAX bf16 pool loads into
the port bit for bit, and a port bf16 trainer's export/load round trip is
bit-exact and gives an equal next loss.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.data.synthetic import \
    SyntheticMultiSlot as JaxSyntheticMultiSlot
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.multislot import MultiSlotTask as JaxMultiSlotTask
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.multislot import MultiSlotTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

TASK = dict(num_tables=4, num_slots=10, embedding_dim=8,
            capacity_per_shard=8192, history_length=6, hidden=(32,),
            merge=True, init_scale=0.0)
DATA = dict(num_slots=10, vocab_per_slot=300, history_length=6,
            batch_size=256)
U = 2048
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _port_trainer(dtype, **task):
    return Trainer(MultiSlotTask(**{**TASK, "table_dtype": dtype, **task}),
                   TrainerConfig(engine=EngineConfig(unique_cap=U, new_cap=U),
                                 log_every=0), device="cpu")


@pytest.fixture(scope="module", params=sorted(DTYPES))
def run(request):
    """Both trainers after 3 shared JAX steps + 3 steps each, and the
    per-step outputs of the last 3."""
    jdtype, pdtype = DTYPES[request.param]
    data = SyntheticMultiSlot(**DATA, seed=5)
    batches = [data.batch() for _ in range(6)]
    jt = JaxTrainer(JaxMultiSlotTask(**TASK, table_dtype=jdtype),
                    JaxTrainerConfig(engine=JaxEngineConfig(
                        num_shards=1, unique_cap=U, new_cap=U), log_every=0))
    pt = _port_trainer(pdtype)
    for i in range(3):
        jt.train_step(*batches[i], ts=100 + i)
    carried = convert.jax_trainer_state(jt)
    convert.load_state(pt, carried)
    jouts, pouts = [], []
    for i in range(3, 6):
        jo = jt.train_step(*batches[i], ts=100 + i)
        po = pt.train_step(*batches[i], ts=100 + i)
        jouts.append({k: np.asarray(jo[k]) for k in ("loss", "preds")})
        pouts.append({k: po[k].numpy() for k in ("loss", "preds")})
    return request.param, jt, pt, carried, jouts, pouts


def test_jax_data_is_the_ports():
    a = SyntheticMultiSlot(**DATA, seed=5)
    b = JaxSyntheticMultiSlot(**DATA, seed=5)
    for _ in range(2):
        (fa, ba), (fb, bb) = a.batch(), b.batch()
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
        np.testing.assert_array_equal(ba["hist_len"], bb["hist_len"])


def test_steps_match_jax(run):
    kind, _, _, _, jouts, pouts = run
    rtol = 1e-5 if kind == "f32" else 1e-4
    for step in range(3):
        np.testing.assert_allclose(pouts[step]["loss"], jouts[step]["loss"],
                                   rtol=rtol, err_msg=f"step {step}")
        if kind == "f32":
            np.testing.assert_allclose(pouts[step]["preds"],
                                       jouts[step]["preds"], rtol=1e-5,
                                       atol=1e-6)


def test_live_pool_rows_match_jax(run):
    kind, jt, pt, _, _, _ = run
    jstate = convert.jax_trainer_state(jt)
    pstate = convert.export_state(pt)
    assert set(pstate["tables"]) == {"table_all"}
    _, jr, _, _ = jstate["stores"]["table_all"]
    live = np.sort(jr)
    ref = jstate["tables"]["table_all"][0][live]
    out = pstate["tables"]["table_all"][0][live]
    assert pt.table_states["table_all"]["data"].dtype == DTYPES[kind][1]
    if kind == "f32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    else:
        # one bf16 ulp: 2^-7 of the value's power of two
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(out - ref) <= ulp), \
            np.max(np.abs(out - ref) / ulp)
        assert np.mean(out == ref) > 0.99


def test_jax_pool_loads_bit_exact(run):
    kind, _, _, carried, _, _ = run
    fresh = _port_trainer(DTYPES[kind][1])
    convert.load_state(fresh, carried)
    np.testing.assert_array_equal(
        fresh.table_states["table_all"]["data"].float().numpy(),
        carried["tables"]["table_all"][0])


@pytest.mark.parametrize("stochastic", [False, True])
def test_bf16_export_load_roundtrip(stochastic):
    data = SyntheticMultiSlot(**DATA, seed=6)
    batches = [data.batch() for _ in range(3)]
    a = _port_trainer(torch.bfloat16, stochastic_rounding=stochastic,
                      init_scale=0.05)
    for i in range(2):
        a.train_step(*batches[i], ts=10 + i)
    state = convert.export_state(a)
    assert state["tables"]["table_all"].dtype == np.float32
    b = _port_trainer(torch.bfloat16, stochastic_rounding=stochastic,
                      init_scale=0.05)
    convert.load_state(b, state)
    assert torch.equal(a.table_states["table_all"]["data"],
                       b.table_states["table_all"]["data"])
    la = a.train_step(*batches[2], ts=12)["loss"].item()
    lb = b.train_step(*batches[2], ts=12)["loss"].item()
    assert la == lb


def test_load_refuses_values_a_bf16_pool_cannot_hold():
    pt = _port_trainer(torch.bfloat16)
    state = convert.export_state(pt)
    state["tables"]["table_all"][0, 0, 0] = 1.0 + 2.0 ** -12
    with pytest.raises(ValueError, match="cannot hold"):
        convert.load_state(pt, state)
