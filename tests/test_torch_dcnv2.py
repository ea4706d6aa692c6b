"""DLRM-DCNv2 (monolith_tpu_torch/models/dlrm_dcnv2.py) against its plain
reference (reference/dlrm_dcnv2.py) on the CPU, at a small size, from the
benchmark's seeded weights.

- the low-rank cross layer against its formula;
- the module's logits, loss and gradients against the reference's
  forward;
- one block of K = 4 steps through `Trainer.train` (the stage worker
  packing steps 1..3, one table on the wide wire) against the reference's
  steps: losses, dense parameters and accumulators, every touched row;
- the wide wire on a table above 65535 unique ids a step, decoded equal to
  `prepare_batch`'s arrays, and a wide table of two features, with and
  without admission, equal to `prepare_batch` in wire and host store;
- the two copies of the reference, and the configuration's widths.

Tolerances: the two sides run the same float32 operations in other orders
(addmm against matmul and add, the card's atomics absent on the CPU);
they agree to a few float32 ulps, so rtol 1e-5 leaves room of ~100x,
and a reference whose products run in bfloat16 (8 bits of mantissa, the
rounding TF32's 10 bits are near) misses by ~5e-3 and fails.
"""

import copy
import json
import os
import threading

import numpy as np
import pytest
import torch

from monolith_tpu_torch.embedding import table as table_lib
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.layers.cross import LowRankCross
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
from monolith_tpu_torch.utils import tracing
from portbench.models import dlrm_dcnv2 as program
from portbench.reference import common
from portbench.streams import criteo_multihot
from reference import dlrm_dcnv2 as ref

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "portbench", "configs",
                       "dcnv2_criteo1tb.json")) as f:
    CFG = json.load(f)
SEED = (1 << 33) + 21
RTOL = 1e-5


def small_cfg():
    """The configuration at a CPU's size: 6 tables (one with a unique cap
    of 70000, so on the wide wire), dim 8, towers 16-8 and 16-8-1, rank 4,
    batch 64; the rest (hotness of 1 to 3, init, optimizers) as the
    configuration's."""
    cfg = copy.deepcopy(CFG)
    for k in [k for k in cfg if k.startswith("rows_")]:
        del cfg[k]
    cfg.update(num_embeddings_per_feature=[50, 3000, 7, 200, 100000, 40],
               multi_hot_sizes=[1, 2, 1, 3, 1, 2], rows_C5=25000,
               embedding_dim=8, bottom_mlp=[16, 8], top_mlp=[16, 8, 1],
               cross_rank=4, batch_size=64)
    held = ref.held_rows(cfg)
    cfg["unique_caps"] = {n: min(h, 256) for n, h in held.items()}
    cfg["unique_caps"]["C5"] = 70000
    return cfg


def dense0(cfg):
    return common.dense_weights(ref.param_shapes(cfg), SEED, "cpu")


def test_low_rank_cross_is_the_formula():
    g = torch.Generator().manual_seed(3)
    layer = LowRankCross(12, num_layers=2, rank=3, generator=g)
    with torch.no_grad():
        for i in range(2):
            getattr(layer, f"b_{i}").uniform_(-1, 1, generator=g)
    x0 = torch.randn(5, 12, generator=g, dtype=torch.float64)
    layer = layer.double()
    x = x0
    for i in range(2):
        V, W = getattr(layer, f"v_{i}"), getattr(layer, f"w_{i}")
        b = getattr(layer, f"b_{i}")
        x = x0 * (torch.einsum("dr,br->bd", W,
                               torch.einsum("rd,bd->br", V, x)) + b) + x
    torch.testing.assert_close(layer(x0), x, rtol=1e-12, atol=1e-12)
    assert getattr(layer, "v_0").shape == (3, 12)
    assert getattr(layer, "w_0").shape == (12, 3)


def _forward_inputs(cfg):
    g = torch.Generator().manual_seed(11)
    B, d = cfg["batch_size"], cfg["embedding_dim"]
    pooled = {n: torch.randn(B, d, generator=g) * 0.3
              for n in ref.feature_names(cfg)}
    _, batch = criteo_multihot.World(cfg, SEED).batch(0, B)
    return pooled, {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_loss_and_gradients_match_the_reference():
    cfg = small_cfg()
    weights = dense0(cfg)
    module = program.build_task(cfg).build_module()
    named = dict(module.named_parameters())
    assert {n: tuple(p.shape) for n, p in named.items()} == \
        ref.param_shapes(cfg)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(weights[n])
    pooled, batch = _forward_inputs(cfg)
    leaves = {n: v.clone().requires_grad_() for n, v in pooled.items()}
    logits = module(leaves, batch)["logits"]
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, batch["label"])
    grads = torch.autograd.grad(loss, list(named.values())
                                + list(leaves.values()))

    params = {n: w.clone().requires_grad_() for n, w in weights.items()}
    rleaves = {n: v.clone().requires_grad_() for n, v in pooled.items()}
    rlogits = ref.forward(params, rleaves, batch, cfg)
    rloss = torch.nn.functional.binary_cross_entropy_with_logits(
        rlogits, batch["label"])
    rgrads = torch.autograd.grad(rloss, [params[n] for n in named]
                                 + list(rleaves.values()))
    torch.testing.assert_close(logits, rlogits, rtol=RTOL, atol=1e-6)
    torch.testing.assert_close(loss, rloss, rtol=RTOL, atol=0)
    for g, r in zip(grads, rgrads):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=1e-7)

    # a reference with bfloat16 products is outside these tolerances
    low = {n: w.bfloat16().float() for n, w in weights.items()}
    lowered = ref.forward(low, {n: v.bfloat16().float()
                                for n, v in pooled.items()}, batch, cfg)
    bound = RTOL * rlogits.abs().max() + 1e-6
    assert (lowered - rlogits).abs().max() > 100 * bound


def test_a_block_through_train_matches_the_reference():
    """K = 4 steps as ONE block of `Trainer.train`, its steps 1..3 packed
    on the stage worker and table C5 on the wide wire, against 4 steps of
    the reference from the same dense weights and seed: each loss,
    each dense parameter and accumulator, each touched row's vector and
    accumulator."""
    cfg = small_cfg()
    K = 4
    caps = tuple(sorted(cfg["unique_caps"].items()))
    tr = Trainer(program.build_task(cfg), TrainerConfig(
        engine=EngineConfig(unique_cap=64, new_cap=64, unique_caps=caps,
                            new_caps=caps),
        seed=SEED, log_every=0, steps_per_dispatch=K), device="cpu")
    assert tr.engine.fuse_wire and tr._stage_overlaps()
    assert [t for t in tr.engine.tables if tr.engine.wide(t)] == ["C5"]
    weights = dense0(cfg)
    with torch.no_grad():
        for n, p in tr.module.named_parameters():
            p.copy_(weights[n])
    world = criteo_multihot.World(cfg, SEED)
    batches = [world.batch(i, cfg["batch_size"]) for i in range(K)]
    losses, hooks = [], []
    with tracing.recording() as rec:
        tr.train(iter(batches), steps=K, hooks=(
            lambda t, out: losses.extend(out["loss"].tolist()),
            lambda *a: hooks.append(1)))
    assert hooks == [1] and len(losses) == K
    main = threading.get_ident()
    packed = [(s.step, s.thread) for s in rec.spans
              if s.name == "stage.prepare"]
    assert [s for s, _ in packed] == list(range(K))
    assert packed[0][1] == main and all(t != main for _, t in packed[1:])

    r = ref.run(cfg, batches, weights, SEED, "cpu", K)
    np.testing.assert_allclose(losses, r["losses"], rtol=RTOL)
    for n, p in tr.module.named_parameters():
        want_p, want_acc = r["dense"][n]
        np.testing.assert_allclose(p.detach().double().numpy(), want_p,
                                   rtol=RTOL, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(tr.opt_state[n].double().numpy(),
                                   want_acc, rtol=RTOL, atol=1e-7, err_msg=n)
    for t, (fids, vectors, norms) in r["rows"].items():
        rows = torch.from_numpy(tr.engine.store_of(t).lookup(fids)
                                .astype(np.int64))
        assert (rows >= 0).all()
        spec, state = tr.engine.tables[t], tr.table_states[t]
        got = table_lib.params_view(spec, state)[rows].double().numpy()
        acc = table_lib.slot_view(spec, state, 0, "norm")[rows].double()
        np.testing.assert_allclose(got, vectors, rtol=RTOL, atol=1e-7,
                                   err_msg=t)
        np.testing.assert_allclose(acc.numpy(), norms, rtol=RTOL, atol=1e-7,
                                   err_msg=t)


def test_wide_wire_on_a_real_table_decodes_to_prepare_batch():
    """B = 4096 bags of 20 uniform ids over 1M rows: ~78k unique ids a
    step, above the 16-bit wire's 65535. The table rides the wire wide,
    and the wire decodes to `prepare_batch`'s arrays (rows, new mask,
    index) on a twin engine, byte for byte what `pack_wire` lays."""
    cfg = small_cfg()
    cfg.update(num_embeddings_per_feature=[1 << 20, 3000, 7, 200, 100000, 40],
               multi_hot_sizes=[20, 2, 1, 3, 1, 2])
    cfg["rows_C1"] = 1 << 20
    cfg["unique_caps"]["C1"] = 90000
    task = program.build_task(cfg)
    caps = tuple(sorted(cfg["unique_caps"].items()))
    engines = [EmbeddingEngine(task.tables(), task.features(),
                               EngineConfig(unique_caps=caps, new_caps=caps),
                               seed=3, device="cpu") for _ in range(2)]
    rng = np.random.default_rng(SEED)
    fb = {f.name: rng.integers(0, min(t.capacity_per_shard, 1 << 20),
                               (4096, f.max_length))
          for f, t in zip(task.features(), task.tables())}
    fb["C1"][7, 3] = -1
    wire, stats = engines[0].prepare_wire(fb, ts=9)
    inputs, stats2 = engines[1].prepare_batch(fb, ts=9)
    assert stats == stats2 and stats["unique"]["C1"] > 65535
    assert stats["overflow"]["C1"] == 0
    wide = [t for t in task.feature_names if engines[0].wide(t)]
    assert wide == ["C1", "C5"]
    np.testing.assert_array_equal(wire, engines[1].pack_wire(inputs))
    decoded = engines[0].decode_wire(torch.from_numpy(wire), 4096)
    for t, tin in inputs.items():
        np.testing.assert_array_equal(decoded[t]["rows"].numpy(), tin["rows"])
        np.testing.assert_array_equal(decoded[t]["new_mask"].numpy(),
                                      tin["new_mask"])
        for f, idx in tin["index"].items():
            np.testing.assert_array_equal(decoded[t]["index"][f].numpy(), idx)
    assert decoded["C1"]["index"]["C1"][7, 3] == -1


@pytest.mark.parametrize("admission", ["none", "sliding"])
@pytest.mark.parametrize("cap", [200_000, 90_000], ids=["fits", "overflows"])
def test_wide_table_of_two_features_equals_prepare_batch(cap, admission):
    """A wide table read by two features, beside a narrow table: the wire
    equals `pack_wire` of `prepare_batch`'s arrays, padding and overflow
    included, step after step, and the host stores end equal, the wide
    table's counts included. `prepare_batch` counts an id's occurrences in a step
    only where the table has admission (the JAX package's path for caps
    above 65535), and so does the wide table; a sliding filter at a
    threshold of 3 then admits the ids seen three times."""
    from monolith_tpu_torch.embedding import initializers, optimizers
    from monolith_tpu_torch.embedding.spec import (AdmissionConfig,
                                                   TableSegment, TableSpec)
    from monolith_tpu_torch.feature import FeatureConfig
    seg = TableSegment(dim=4, optimizer=optimizers.Adagrad(),
                       initializer=initializers.Zeros())
    tables = [TableSpec(name="big", capacity_per_shard=1 << 20,
                        segments=(seg,), admission=AdmissionConfig(
                            kind=admission, threshold=3,
                            filter_capacity=1 << 20)),
              TableSpec(name="small", capacity_per_shard=4096,
                        segments=(seg,))]
    feats = [FeatureConfig("a", "big", 12), FeatureConfig("b", "big", 5),
             FeatureConfig("c", "small", 3)]
    caps = (("big", cap), ("small", 4096))
    engines = [EmbeddingEngine(tables, feats, EngineConfig(
        unique_caps=caps, new_caps=caps), seed=3, device="cpu")
        for _ in range(2)]
    assert engines[0].wide("big") and not engines[0].wide("small")
    rng = np.random.default_rng(SEED)
    B = 8192
    for step in range(3):
        fb = {"a": rng.integers(0, 1 << 20, (B, 12)),
              "b": rng.integers(0, 1 << 12, (B, 5)),
              "c": rng.integers(0, 2000, (B, 3))}
        fb["a"][rng.random((B, 12)) < 0.01] = -1
        wire, stats = engines[0].prepare_wire(fb, ts=step)
        inputs, stats2 = engines[1].prepare_batch(fb, ts=step)
        assert stats == stats2
        assert (stats["overflow"]["big"] > 0) == (cap == 90_000)
        assert (stats["filtered"]["big"] > 0) == (admission != "none")
        np.testing.assert_array_equal(wire, engines[1].pack_wire(inputs))
    # the narrow table keeps the 16-bit wire's counts (each occurrence, as
    # the JAX package's wire counts them): its counts are left out
    for t, n in (("big", 4), ("small", 3)):
        got, want = engines[0].stores[t].save(), engines[1].stores[t].save()
        order = [np.argsort(g[0]) for g in (got, want)]
        for a, b in zip(got[:n], want[:n]):
            np.testing.assert_array_equal(a[order[0]], b[order[1]])


def test_the_two_copies_of_the_reference_agree():
    with open(os.path.join(ROOT, "reference", "dlrm_dcnv2.py")) as a, \
            open(os.path.join(ROOT, "portbench", "reference",
                              "dlrm_dcnv2.py")) as b:
        assert a.read() == b.read()


def test_the_configuration_widths():
    """The program's task and module at dcnv2_criteo1tb.json's widths:
    26 tables of 128, held rows 51,883,621, hotness 214 an example, the
    interaction 3456 wide, every dense parameter the reference's shape;
    the three tables above 65535 unique ids a step on the wide wire."""
    task = program.build_task(CFG)
    tables, feats = task.tables(), task.features()
    assert [t.dim for t in tables] == [128] * 26
    assert sum(t.capacity_per_shard for t in tables) == 51_883_621
    assert [f.max_length for f in feats] == CFG["multi_hot_sizes"]
    assert sum(f.max_length for f in feats) == 214
    assert all(f.combiner == "sum" and f.table == f.name for f in feats)
    assert ref.interaction_width(CFG) == 27 * 128 == 3456
    module = task.build_module()
    assert {n: tuple(p.shape) for n, p in module.named_parameters()} == \
        ref.param_shapes(CFG)
    caps = tuple(sorted(CFG["unique_caps"].items()))
    probe = EmbeddingEngine(
        [type(t)(**dict(t.__dict__, capacity_per_shard=1)) for t in tables],
        feats, EngineConfig(unique_caps=caps, new_caps=caps), device="cpu")
    assert probe.fuse_wire
    assert sorted(t for t in probe.tables if probe.wide(t)) == \
        ["C20", "C21", "C22"]
    assert ref.train_flops_per_example(CFG) == 96_182_784
