"""The multislot modules of monolith_tpu_torch against the JAX package's:
merge_table_specs on the bench's spec list, DIN and the bf16 MLP forward
on converted flax weights, the whole MultiSlotModule, and the bench's bf16
variant (bf16 pools, stochastic rounding, bf16 dense tower) trained at a
small size to the JAX package's own AUC bar.

Tolerances: f32 forwards to atol 1e-5 (sums in another order). A bf16
tower to 2^-8 (rtol and atol): flax's bf16 Dense rounds the product to
bf16 and adds the bias in bf16, and the port does the same, but two
libraries may accumulate the products in another order, and a layer's
output can then differ by a bf16 ulp. (On this CPU the two agree bit for
bit.) The same tower computed in f32 differs from the bf16 one by more
than that, which the tests check, so the bound tells the two apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.embedding.merge import merge_table_specs as jax_merge
from monolith_tpu.layers.feature_seq import DIN as JaxDIN
from monolith_tpu.layers.mlp import MLP as JaxMLP
from monolith_tpu.models.multislot import MultiSlotModule as JaxMultiSlotModule
from monolith_tpu.models.multislot import MultiSlotTask as JaxMultiSlotTask
from monolith_tpu_torch import convert
from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.embedding.merge import merge_table_specs
from monolith_tpu_torch.embedding.spec import TableSpec
from monolith_tpu_torch.layers.feature_seq import DIN
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.models.multislot import MultiSlotModule, MultiSlotTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

BF16_TOL = 2.0 ** -8
BENCH = dict(num_tables=16, num_slots=40, embedding_dim=16,
             capacity_per_shard=1 << 18, history_length=20,
             hidden=(256, 128, 64))


def _load_flax(module, params):
    named = {k: torch.from_numpy(np.array(v))
             for k, v in convert._to_module_tensors(params).items()}
    assert set(named) == {n for n, _ in module.named_parameters()}
    module.load_state_dict(named)
    return module


def _groups(mapping):
    """The partition of original tables that a merge produced."""
    out = {}
    for orig, merged in mapping.items():
        out.setdefault(merged, set()).add(orig)
    return sorted(sorted(g) for g in out.values())


@pytest.mark.parametrize("max_group_bytes", [0, 6 << 26, 1 << 28])
@pytest.mark.parametrize("bf16", [False, True])
def test_merge_matches_jax_on_the_bench_specs(max_group_bytes, bf16):
    jtask = JaxMultiSlotTask(**BENCH, table_dtype=jnp.bfloat16 if bf16
                             else jnp.float32, stochastic_rounding=bf16)
    ptask = MultiSlotTask(**BENCH, table_dtype=torch.bfloat16 if bf16
                          else torch.float32, stochastic_rounding=bf16)
    jspecs, jfeats = jtask._raw()
    pspecs, pfeats = ptask._raw()
    jm, jf, jmap = jax_merge(jspecs, jfeats, max_group_bytes=max_group_bytes)
    pm, pf, pmap = merge_table_specs(pspecs, pfeats,
                                     max_group_bytes=max_group_bytes)
    assert _groups(pmap) == _groups(jmap)
    assert sorted(s.capacity_per_shard for s in pm) == \
        sorted(s.capacity_per_shard for s in jm)
    # features land on the same groups
    inv_j = {m: frozenset(o for o, mm in jmap.items() if mm == m)
             for m in jmap.values()}
    inv_p = {m: frozenset(o for o, mm in pmap.items() if mm == m)
             for m in pmap.values()}
    assert [(f.name, inv_p[f.table]) for f in pf] == \
        [(f.name, inv_j[f.table]) for f in jf]


def test_merge_keys_cover_dtype_and_rounding():
    seg = MultiSlotTask()._segments()
    specs = [TableSpec("a", 100, seg), TableSpec("b", 100, seg),
             TableSpec("c", 100, seg, dtype=torch.bfloat16),
             TableSpec("d", 100, seg, dtype=torch.bfloat16,
                       stochastic_rounding=True)]
    merged, _, mapping = merge_table_specs(specs, [])
    assert len(merged) == 3
    assert mapping["c"] == "c" and mapping["d"] == "d"
    assert mapping["a"] == mapping["b"] != "a"


def test_stochastic_rounding_needs_a_bf16_table():
    with pytest.raises(ValueError, match="bfloat16"):
        TableSpec("t", 8, MultiSlotTask()._segments(),
                  stochastic_rounding=True)


def test_bench_bf16_config_is_one_bf16_table():
    task = MultiSlotTask(**BENCH, merge=True, table_dtype=torch.bfloat16,
                         stochastic_rounding=True, dense_dtype=torch.bfloat16)
    (spec,) = task.tables()
    assert spec.name == "table_all"
    assert spec.capacity_per_shard == 17 * (1 << 18)
    assert spec.dtype == torch.bfloat16 and spec.stochastic_rounding
    assert {f.table for f in task.features()} == {"table_all"}


@pytest.mark.parametrize("seed", [0, 1])
def test_din_matches_flax(seed):
    rng = np.random.default_rng(seed)
    b, t, h = 16, 5, 8
    q = rng.normal(size=(b, h)).astype(np.float32)
    k = rng.normal(size=(b, t, h)).astype(np.float32)
    mask = np.arange(t)[None, :] < rng.integers(1, t + 1, size=b)[:, None]
    jdin = JaxDIN()
    params = jdin.init(jax.random.PRNGKey(seed), q, k, mask)["params"]
    ref = np.asarray(jdin.apply({"params": params}, q, k, mask))
    din = _load_flax(DIN(h, t), params)
    out = din(torch.from_numpy(q), torch.from_numpy(k),
              torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_mlp_matches_flax(bf16):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 48)).astype(np.float32)
    dims = (64, 32, 1)
    jmlp = JaxMLP(output_dims=dims,
                  compute_dtype=jnp.bfloat16 if bf16 else None)
    params = jmlp.init(jax.random.PRNGKey(0), x)["params"]
    ref = np.asarray(jmlp.apply({"params": params}, x))
    mlp = _load_flax(MLP(48, dims, compute_dtype=torch.bfloat16 if bf16
                         else None), params)
    out = mlp(torch.from_numpy(x))
    assert out.dtype == torch.float32
    tol = BF16_TOL if bf16 else 1e-5
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=tol, atol=tol)
    if bf16:
        f32 = np.asarray(JaxMLP(output_dims=dims).apply({"params": params},
                                                        x))
        assert np.max(np.abs(f32 - ref)) > tol
    out.sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in mlp.parameters())


@pytest.mark.parametrize("bf16", [False, True])
def test_multislot_module_matches_flax(bf16):
    rng = np.random.default_rng(4)
    b, slots, d, t = 32, 6, 8, 5
    pooled = {f"slot_{s}": rng.normal(size=(b, 1 + d)).astype(np.float32)
              for s in range(slots)}
    pooled["hist_items"] = rng.normal(size=(b, t, 1 + d)).astype(np.float32)
    batch = {"hist_len": rng.integers(1, t + 1, size=b).astype(np.int32)}
    kw = dict(embedding_dim=d, hidden=(32, 16), num_slots=slots,
              history_length=t)
    jmod = JaxMultiSlotModule(**kw, dense_dtype=jnp.bfloat16 if bf16
                              else None)
    params = jmod.init(jax.random.PRNGKey(1), pooled, batch)["params"]
    ref = np.asarray(jmod.apply({"params": params}, pooled, batch)["logits"])
    pmod = _load_flax(MultiSlotModule(**kw, dense_dtype=torch.bfloat16 if bf16
                                      else None), params)
    out = pmod({k: torch.from_numpy(v) for k, v in pooled.items()},
               {k: torch.from_numpy(v) for k, v in batch.items()})["logits"]
    tol = BF16_TOL if bf16 else 1e-5
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=tol, atol=tol)


def test_bf16_bench_variant_trains():
    """The bench's bf16 variant, scaled down as the JAX package's own test
    (tests/test_models.py) scales it, with its AUC bar."""
    task = MultiSlotTask(num_tables=4, num_slots=10, embedding_dim=8,
                         capacity_per_shard=8192, history_length=6,
                         hidden=(32,), merge=True, table_dtype=torch.bfloat16,
                         stochastic_rounding=True, dense_dtype=torch.bfloat16)
    tr = Trainer(task, TrainerConfig(
        engine=EngineConfig(unique_cap=2048, new_cap=2048), log_every=0),
        device="cpu")
    data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                              history_length=6, batch_size=256, seed=1)
    res = tr.train(iter(data), steps=41)
    assert np.isfinite(res["loss"])
    assert res["auc"] > 0.515, res
    for st in tr.table_states.values():
        assert st["data"].dtype == torch.bfloat16


def test_task_fields_mirror_jax():
    names = {f.name for f in dataclasses.fields(JaxMultiSlotTask)}
    assert names == {f.name for f in dataclasses.fields(MultiSlotTask)}
