"""bench.py's default multislot configuration in the port (profile_step's
`multislot`: 16 + 1 tables merged into one f32 pool, f32 tower, no
rounding), on the CPU.

The config runs here at a small capacity, batch and cap (4,096 rows a
table, batch 128, unique_cap 8192) at the configuration's full widths (40
slots, a 20-long DIN history, dim 16, hidden (256, 128, 64)), against the
JAX package's `MultiSlotTask(table_dtype=jnp.float32, merge=True)`
trainer: 3 JAX steps, the state carried into the port by convert.py, then
2 more steps in each on batches the first 3 admitted (so that no new row
draws an init, whose PRNGs differ). Tolerances as
tests/test_torch_multislot_trainer.py's f32 pools: losses and preds rtol
1e-5 (atol 1e-6 for preds), live pool rows atol 1e-5.

`merge_max_gb` bins the tables as MT_BENCH_MERGE_MAX_GB does; at the full
capacity the f32 pool is 2,281,701,376 B, and the rows from 4,194,304 on
start past byte 2^31 (the shape bench_rows.py and chip_smoke.py phase 20
give K1 and K2 on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.multislot import MultiSlotTask as JaxMultiSlotTask
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import bench_rows, convert, profile_step
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.models.multislot import MultiSlotTask

torch.set_num_threads(1)

CAP, BATCH, U = 4096, 128, 8192
FULL = dict(num_tables=16, num_slots=40, embedding_dim=16,
            capacity_per_shard=1 << 18, history_length=20,
            hidden=(256, 128, 64), merge=True)


def _small(**kw):
    return profile_step.CONFIGS["multislot"](
        batch_size=BATCH, unique_cap=U, capacity_per_shard=CAP,
        device="cpu", **kw)


@pytest.fixture(scope="module")
def run():
    """The config's trainer and the JAX trainer after 3 JAX steps, the
    carried state and 2 steps each; K3 calls counted on the port's side."""
    rounded = []
    real = ptable.stochastic_round_bf16

    def counted(x, seed):
        rounded.append(seed)
        return real(x, seed)
    ptable.stochastic_round_bf16 = counted
    try:
        pt, data = _small()
        batches = [data.batch() for _ in range(3)]
        jt = JaxTrainer(JaxMultiSlotTask(**dict(FULL, capacity_per_shard=CAP),
                                         table_dtype=jnp.float32),
                        JaxTrainerConfig(engine=JaxEngineConfig(
                            num_shards=1, unique_cap=U, new_cap=U),
                            log_every=0))
        for i, b in enumerate(batches):
            jt.train_step(*b, ts=100 + i)
        convert.load_state(pt, convert.jax_trainer_state(jt))
        outs = []
        for i, b in enumerate(batches[1:]):
            jo = jt.train_step(*b, ts=200 + i)
            po = pt.train_step(*b, ts=200 + i)
            assert not any(po["stats"]["overflow"].values())
            outs.append((jo, po))
    finally:
        ptable.stochastic_round_bf16 = real
    return pt, jt, outs, rounded


def test_config_is_one_merged_f32_table_of_width_128(run):
    pt = run[0]
    task = pt.task
    assert isinstance(task, MultiSlotTask)
    assert (task.table_dtype, task.stochastic_rounding, task.dense_dtype) \
        == (torch.float32, False, None)
    assert [t.name for t in task.tables()] == ["table_all"]
    pool = pt.table_states["table_all"]["data"]
    assert pool.dtype == torch.float32
    assert tuple(pool.shape) == (17 * CAP, 128)
    assert pt.config.engine.unique_cap == pt.config.engine.new_cap == U
    assert not pt.config.engine.async_optimize


def test_no_k3_on_the_f32_path(run):
    assert run[3] == []


def test_two_steps_match_jax(run):
    _, _, outs, _ = run
    for i, (jo, po) in enumerate(outs):
        np.testing.assert_allclose(po["loss"].numpy(), np.asarray(jo["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(po["preds"].numpy(),
                                   np.asarray(jo["preds"]), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {i}")


def test_live_pool_rows_match_jax(run):
    pt, jt, _, _ = run
    jstate = convert.jax_trainer_state(jt)
    pstate = convert.export_state(pt)
    _, jr, _, _ = jstate["stores"]["table_all"]
    live = np.sort(jr)
    assert len(live) > 1000
    np.testing.assert_allclose(pstate["tables"]["table_all"][0][live],
                               jstate["tables"]["table_all"][0][live],
                               atol=1e-5, rtol=0)


def test_merge_max_gb_bins_17_tables_into_8_8_and_1():
    """17 members of 2^18 rows x 512 B = 128 MiB at a 1 GiB cap: pools of
    8, 8 and 1 tables, the single one under its own name; as the JAX
    package bins them."""
    port = MultiSlotTask(**FULL, merge_max_bytes=1 << 30)
    jax_task = JaxMultiSlotTask(**FULL, merge_max_bytes=1 << 30,
                                table_dtype=jnp.float32)
    got = [(t.name, t.capacity_per_shard) for t in port.tables()]
    assert got == [("table_all_0", 8 << 18), ("table_all_1", 8 << 18),
                   ("table_hist", 1 << 18)]
    assert got == [(t.name, t.capacity_per_shard) for t in jax_task.tables()]
    tables = {f.table for f in port.features()}
    assert tables == {"table_all_0", "table_all_1", "table_hist"}
    assert [(f.name, f.table) for f in port.features()] == \
        [(f.name, f.table) for f in jax_task.features()]


def test_config_takes_merge_max_gb():
    """The config's merge_max_gb, scaled to the small capacity (8 tables
    of 4,096 x 512 B = 16 MiB a bin): three f32 pools."""
    pt, _ = _small(merge_max_gb=16 / 1024)
    assert {t: tuple(s["data"].shape) for t, s in pt.table_states.items()} \
        == {"table_all_0": (8 * CAP, 128), "table_all_1": (8 * CAP, 128),
            "table_hist": (CAP, 128)}
    assert all(s["data"].dtype == torch.float32
               for s in pt.table_states.values())


def test_bench_configs_name_the_f32_multislot():
    assert set(profile_step.CONFIGS) == {"deepfm", "multislot",
                                         "multislot_bf16"}
    assert profile_step.SERVE_UNIQUE_CAP["multislot"] == 49152
    bf16, _ = profile_step.CONFIGS["multislot_bf16"](
        batch_size=BATCH, unique_cap=U, capacity_per_shard=CAP, device="cpu")
    assert (bf16.task.table_dtype, bf16.task.stochastic_rounding,
            bf16.task.dense_dtype) == (torch.bfloat16, True, torch.bfloat16)


def test_f32_shape_reaches_past_byte_2_31():
    cap, width, dtype, u = bench_rows.SHAPES["multislot_f32"]
    row_bytes = width * torch.finfo(dtype).bits // 8
    assert (cap, width, dtype, u) == (17 << 18, 128, torch.float32, 49152)
    assert cap * row_bytes == 2_281_701_376
    first_past = (1 << 31) // row_bytes
    assert first_past == 4_194_304 and cap - first_past == 262_144
    # bench_rows' case at this shape has 44,226 valid rows
    k1, k2 = bench_rows.bounds_ms(u, 44_226, row_bytes)
    assert round(k1, 5) == 0.01433 and round(k2, 5) == 0.01358
