"""The asynchronous block's deferred write-backs and their K3 keys, in both
packages (fault F5 of the port, repaired; fault R9 of the JAX package,
pinned).

The 1-step-stale block lands step s-1's write-back inside step s, keyed by
s, and the last step's after its loop. The port keys that last one by the
step that would have landed it inside the loop, base step + K, so no two
deferred write-backs of a run share a K3 key. The JAX package keys it with
step 0 in every block (`monolith_tpu/training/trainer.py:359-362`), so
every block's last write-back rounds with one key.

Small shapes: DeepFM (dim 8, hidden (16,), capacity 2048, unique_cap 512,
batch 16) and the merged multislot (4 tables, dim 8), bf16 pools with
stochastic rounding, blocks of K = 4, inputs made from a seed with numpy.
The JAX side replaces its rounding by a fill with one number drawn from
its key (as tests/test_torch_soa_sharded.py pins R6), the port's by a fill
with one number made from its seed: a row then shows which key wrote it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.ops import rounding as jrounding
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.embedding.engine import EngineConfig, _defer_seed
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.models.multislot import MultiSlotTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

K, SEED, B = 4, 13, 16
DEEPFM = dict(embedding_dim=8, capacity_per_shard=2048, hidden=(16,))
MULTISLOT = dict(num_tables=4, num_slots=10, embedding_dim=8,
                 capacity_per_shard=8192, history_length=6, hidden=(32,),
                 merge=True)


def _disjoint_pairs(n):
    """n DeepFM batches, step s drawing its ids from [100 s, 100 s + 50):
    no id is read by two steps, so every row is written by one deferred
    write-back only."""
    rng = np.random.default_rng(SEED)
    pairs = []
    for s in range(n):
        ids = np.arange(100 * s, 100 * s + 50)
        fb = {"user_id": rng.choice(ids, (B, 1)).astype(np.int64),
              "item_id": rng.choice(ids, (B, 1)).astype(np.int64),
              "hist_items": rng.choice(ids, (B, 10)).astype(np.int64)}
        pairs.append((fb, {"label": rng.integers(0, 2, B)
                           .astype(np.float32)}))
    return pairs


def _ids(pair):
    return np.unique(np.concatenate([v.ravel() for v in pair[0].values()]))


def _port(kind):
    bf16 = dict(table_dtype=torch.bfloat16, stochastic_rounding=True)
    if kind == "deepfm":
        task = DeepFMTask(**DEEPFM, **bf16)
        cap, data = 512, None
    else:
        task = MultiSlotTask(**MULTISLOT, **bf16)
        cap = 2048
        data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                                  history_length=6, batch_size=64, seed=3)
    tr = Trainer(task, TrainerConfig(engine=EngineConfig(
        unique_cap=cap, new_cap=cap, async_optimize=True), log_every=0,
        seed=SEED, steps_per_dispatch=K), device="cpu")
    if data is None:
        return tr, _disjoint_pairs(1 + 2 * K)
    return tr, [data.batch() for _ in range(1 + 2 * K)]


@pytest.mark.parametrize("staged", [False, True], ids=["packed", "staged"])
@pytest.mark.parametrize("kind", ["deepfm", "multislot"])
def test_every_deferred_write_back_gets_its_own_key(kind, staged,
                                                    monkeypatch):
    """F5: one train_step, then two asynchronous blocks of K. Every
    deferred write-back hands scatter_packed a seed of its own; the one
    after each block's loop is _defer_seed(seed, base + K, 0, 0)."""
    tr, pairs = _port(kind)
    tr.train_step(*pairs[0], ts=1)
    seeds = []
    real = ptable.scatter_packed

    def recorded(spec, state, rows, values, seed=None):
        seeds.append(seed)
        return real(spec, state, rows, values, seed=seed)
    monkeypatch.setattr(ptable, "scatter_packed", recorded)
    finals = []
    for blk in range(2):
        base, chunk = tr.step, pairs[1 + blk * K:1 + (blk + 1) * K]
        staged_blk = tr.stage_block(chunk, ts=2 + blk) if staged else None
        tr.train_step_block(chunk, ts=2 + blk, staged=staged_blk)
        finals.append(_defer_seed(SEED, base + K, 0, 0))
        assert seeds[-1] == finals[-1]
    # K - 1 write-backs land inside each loop, one after it
    assert len(seeds) == 2 * K
    assert len(set(seeds)) == len(seeds), seeds
    assert seeds == [_defer_seed(SEED, s, 0, 0)
                     for s in (*range(2, 2 + K), *range(2 + K, 2 + 2 * K))]
    assert finals[0] != finals[1]
    assert tr.step == 1 + 2 * K


def _filled_rows(pool, rows):
    """The one number each of `rows` holds across its columns."""
    vals = np.unique(pool[rows])
    assert len(vals) == 1, vals
    return float(vals[0])


def test_r9_jax_lands_every_blocks_last_write_back_with_one_key(monkeypatch):
    """Fault R9, pinned in both packages. JAX: a bf16 stochastic-rounding
    DeepFM with async_optimize, its rounding replaced by a fill with one
    number drawn from its key; one step, then two blocks of K on ids that
    no other step reads. The rows that only each block's final write-back
    stored hold the same number after block 1 and after block 2 (one key
    for both), while the rows of an inner write-back hold another. The
    port, its rounding replaced by a fill made from its seed: the two
    blocks' final rows hold two different numbers."""
    def keyed_fill(x, key):
        return jnp.full(x.shape, jax.random.uniform(key, (), minval=1.0,
                                                    maxval=2.0), jnp.bfloat16)
    monkeypatch.setattr(jrounding, "stochastic_round_bf16", keyed_fill)
    pairs = _disjoint_pairs(1 + 2 * K)
    last1, last2, inner = (_ids(pairs[K]), _ids(pairs[2 * K]),
                           _ids(pairs[K - 1]))
    jt = JaxTrainer(JaxDeepFMTask(**DEEPFM, table_dtype=jnp.bfloat16,
                                  stochastic_rounding=True),
                    JaxTrainerConfig(engine=JaxEngineConfig(
                        num_shards=1, unique_cap=512, new_cap=512,
                        async_optimize=True), log_every=0, seed=SEED,
                        steps_per_dispatch=K))
    jt.train_step(*pairs[0], ts=1)
    store = jt.engine.stores["sparse"][0]

    def jax_pool():
        return np.asarray(jt.table_states["sparse"]["data"],
                          np.float32).reshape(-1,
                              jt.table_states["sparse"]["data"].shape[-1])

    jt.train_step_block(pairs[1:1 + K], ts=2)
    after1 = _filled_rows(jax_pool(), store.lookup(last1))
    jt.train_step_block(pairs[1 + K:], ts=3)
    pool = jax_pool()
    assert _filled_rows(pool, store.lookup(last1)) == after1
    assert _filled_rows(pool, store.lookup(last2)) == after1   # R9
    assert _filled_rows(pool, store.lookup(inner)) != after1

    def seeded_fill(x, seed):
        return torch.full(x.shape, 1.0 + (seed % 1021) / 1021,
                          dtype=torch.bfloat16)
    monkeypatch.setattr(ptable, "stochastic_round_bf16", seeded_fill)
    pt = Trainer(DeepFMTask(**DEEPFM, table_dtype=torch.bfloat16,
                            stochastic_rounding=True),
                 TrainerConfig(engine=EngineConfig(
                     unique_cap=512, new_cap=512, async_optimize=True),
                     log_every=0, seed=SEED, steps_per_dispatch=K),
                 device="cpu")
    pt.train_step(*pairs[0], ts=1)
    pt.train_step_block(pairs[1:1 + K], ts=2)
    pt.train_step_block(pairs[1 + K:], ts=3)
    pstore = pt.engine.store_of("sparse")
    ppool = pt.table_states["sparse"]["data"].float().numpy()
    finals = [_filled_rows(ppool, pstore.lookup(ids)) for ids in (last1,
                                                                  last2)]
    assert finals[0] != finals[1]
    assert finals == [np.float32(torch.tensor(
        1.0 + (_defer_seed(SEED, s, 0, 0) % 1021) / 1021,
        dtype=torch.bfloat16).float()) for s in (1 + K, 1 + 2 * K)]
