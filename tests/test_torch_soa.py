"""The structure-of-arrays table state and the multi-array step of
monolith_tpu_torch against the JAX package's (`EngineConfig(packed="off")`,
`compact_wire=False`; unique caps above 65535, which the port carries on
its wire as a wide table).

- table: `create_state(packed=False)`, `init_rows` (Constants and
  init_scale 0.0: the two packages' PRNGs differ), `apply_gradients` (f32
  to rtol 1e-6; a bf16 table rounded to nearest, and stochastically with
  the JAX noise handed to the port's arithmetic, `round_with_noise`),
  `restore_packed_rows`, `full_rows` against `tiered.pack_rows`, the views
  and host accessors, `state_from_np(packed=False)`, `zero_rows`;
- engine: `prepare_batch`'s new-row channels (`new_pos`, `new_rows`,
  `revive_rows`) array for array with compact on and off and admission on
  and off, `fuse_wire` over a grid of settings (equal to JAX's but where
  a cap above 65535 takes the port's wide wire), `prepare_wire` refusing
  what the wire cannot carry, `pack_arrays` / `decode_arrays`;
- trainer: a structure-of-arrays DeepFM (f32), a packed DeepFM without the
  compact wire (both on the multi-array path) and one with a unique cap of
  70000 (the port's wide wire, the JAX package's multi-array path) against
  the JAX trainer over carried steps (losses, preds, params, slots, eval);
  `steps_per_dispatch` steps one by one off the fused wire;
- checkpoints and `convert` across layouts and packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from monolith_tpu.embedding import table as jtable
from monolith_tpu.embedding import tiered as jtiered
from monolith_tpu.embedding.engine import EmbeddingEngine as JaxEngine
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.models.multislot import MultiSlotTask as JaxMultiSlotTask
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.models.multislot import MultiSlotTask
from monolith_tpu_torch.ops import rounding
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

CAP = 512
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _specs(dtype="f32", **kw):
    """DeepFM's table (1-wide SGD bias + 4-wide Adagrad vector) in both
    packages, in `dtype`."""
    jd, pd = DTYPES[dtype]
    return (JaxDeepFMTask(embedding_dim=4, capacity_per_shard=CAP,
                          table_dtype=jd, **kw).tables()[0],
            DeepFMTask(embedding_dim=4, capacity_per_shard=CAP,
                       table_dtype=pd, **kw).tables()[0])


def _jax_state_np(st):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), st)


def _port_state_np(st):
    return jax.tree.map(lambda a: a.float().numpy(), st)


def _random_state(jspec, pspec, seed):
    """The same structure-of-arrays state in both packages: random params
    (exact in the table's dtype) and positive slots."""
    rng = np.random.default_rng(seed)
    js = jtable.create_state(jspec, packed=False)
    ps = ptable.create_state(pspec, "cpu", packed=False)
    params = np.array(jnp.asarray(rng.normal(size=(CAP, jspec.dim)),
                                  jspec.dtype).astype(jnp.float32))
    js["params"] = jnp.asarray(params, jspec.dtype)
    ps["params"] = torch.from_numpy(params).to(pspec.dtype)
    for i, seg in enumerate(js["slots"]):
        for name, arr in seg.items():
            v = rng.uniform(0.01, 2.0, size=arr.shape).astype(np.float32)
            js["slots"][i][name] = jnp.asarray(v)
            ps["slots"][i][name] = torch.from_numpy(v)
    return js, ps


def _rows(seed, n=97):
    """Unique rows with -1 and rows beyond the pool among them."""
    rng = np.random.default_rng(seed)
    rows = rng.permutation(CAP)[:n].astype(np.int32)
    rows[rng.random(n) < 0.1] = -1
    rows[3] = CAP + 5
    return rows


def _assert_states_equal(ps, js, rtol=0.0, what=""):
    a, b = _port_state_np(ps), _jax_state_np(js)
    np.testing.assert_allclose(a["params"], b["params"], rtol=rtol, atol=0,
                               err_msg=f"{what} params")
    assert len(a["slots"]) == len(b["slots"])
    for i, seg in enumerate(b["slots"]):
        assert set(a["slots"][i]) == set(seg)
        for name in seg:
            np.testing.assert_allclose(a["slots"][i][name], seg[name],
                                       rtol=rtol, atol=0,
                                       err_msg=f"{what} seg{i}/{name}")


# ----------------------------------------------------------------------
# table
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_create_state_structure_of_arrays_matches_jax(dtype):
    jspec, pspec = _specs(dtype)
    js = jtable.create_state(jspec, packed=False)
    ps = ptable.create_state(pspec, "cpu", packed=False)
    assert ps["params"].dtype == pspec.dtype
    assert all(a.dtype == torch.float32 for seg in ps["slots"]
               for a in seg.values())
    _assert_states_equal(ps, js)
    # by default the packed pool for f32 / bf16, as in the JAX package
    assert "data" in ptable.create_state(pspec, "cpu")
    assert ptable.is_packed(pspec) and jtable.is_packed(jspec)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_init_rows_matches_jax(dtype):
    """init_scale 0.0: zero params, slots reset to their init value; -1
    and rows beyond the pool drop."""
    jspec, pspec = _specs(dtype, init_scale=0.0)
    js, ps = _random_state(jspec, pspec, 1)
    rows = _rows(2, 40)
    js = jtable.init_rows(jspec, js, jnp.asarray(rows),
                          jax.random.PRNGKey(0))
    ptable.init_rows(pspec, ps, torch.from_numpy(rows), torch.Generator())
    _assert_states_equal(ps, js)


def test_init_rows_draws_the_initializer():
    """A random initializer: the new rows' params by distribution (the
    PRNGs differ), every other row untouched."""
    _, pspec = _specs(init_scale=0.5)
    ps = ptable.create_state(pspec, "cpu", packed=False)
    rows = torch.arange(0, CAP, 2, dtype=torch.int32)
    ptable.init_rows(pspec, ps, rows, torch.Generator().manual_seed(3))
    drawn = ps["params"][rows.long()]
    assert 0.2 < float(drawn.abs().max()) <= 0.5
    assert float(drawn.std()) > 0.1
    assert not ps["params"][1::2].any()


@pytest.mark.parametrize("dtype,step", [("f32", 0), ("f32", 7), ("bf16", 3)])
def test_apply_gradients_matches_jax(dtype, step):
    """Round to nearest (no stochastic rounding): f32 to rtol 1e-6; a bf16
    table's params within one bf16 ulp (the f32 row math may differ in its
    last bit), its f32 slots to rtol 1e-6."""
    jspec, pspec = _specs(dtype)
    js, ps = _random_state(jspec, pspec, step)
    rows = _rows(step + 10)
    grads = np.random.default_rng(step).normal(
        size=(len(rows), jspec.dim)).astype(np.float32) * 0.1
    js = jtable.apply_gradients(jspec, js, jnp.asarray(rows),
                                jnp.asarray(grads), jnp.int32(step))
    ptable.apply_gradients(pspec, ps, torch.from_numpy(rows),
                           torch.from_numpy(grads), step)
    a, b = _port_state_np(ps), _jax_state_np(js)
    # atol 1e-8: one f32 ulp of the updated values near 0.003
    ulp = 2.0 ** -7 if dtype == "bf16" else 1e-6
    np.testing.assert_allclose(a["params"], b["params"], rtol=ulp, atol=1e-8)
    for i, seg in enumerate(b["slots"]):
        for name in seg:
            np.testing.assert_allclose(a["slots"][i][name], seg[name],
                                       rtol=1e-6, atol=1e-8)
    # dropped rows kept what they held
    untouched = np.setdiff1d(np.arange(CAP), rows)
    np.testing.assert_array_equal(
        a["params"][untouched], _port_state_np(_random_state(
            jspec, pspec, step)[1])["params"][untouched])


def test_apply_gradients_bf16_stochastic_rounding_matches_jax(monkeypatch):
    """bf16 + stochastic_rounding: the JAX package narrows the new params
    with `stochastic_round_bf16(p, key)`; the port with K3 on the
    concatenated [m, dim] f32 params. Handed the JAX noise for that key
    (the port's `round_with_noise`), the port's params equal JAX's bit for
    bit wherever the f32 row math agrees, and within one bf16 ulp
    everywhere."""
    jspec, pspec = _specs("bf16", stochastic_rounding=True)
    js, ps = _random_state(jspec, pspec, 5)
    rows = _rows(6)
    grads = np.random.default_rng(6).normal(
        size=(len(rows), jspec.dim)).astype(np.float32) * 0.01
    key = jax.random.PRNGKey(42)
    js = jtable.apply_gradients(jspec, js, jnp.asarray(rows),
                                jnp.asarray(grads), jnp.int32(2), key=key)
    noise = np.asarray(jax.random.randint(key, (len(rows), jspec.dim), 0,
                                          1 << 16, dtype=jnp.uint32))
    seen = []

    def with_jax_noise(x, seed):
        seen.append((tuple(x.shape), x.dtype, x.is_contiguous(), seed))
        return rounding.round_with_noise(
            x, torch.from_numpy(noise.astype(np.int64)))
    monkeypatch.setattr(ptable, "stochastic_round_bf16", with_jax_noise)
    ptable.apply_gradients(pspec, ps, torch.from_numpy(rows),
                           torch.from_numpy(grads), 2, seed=99)
    assert seen == [((len(rows), jspec.dim), torch.float32, True, 99)]
    a, b = _port_state_np(ps), _jax_state_np(js)
    np.testing.assert_allclose(a["params"], b["params"], rtol=2.0 ** -7,
                               atol=0)
    assert np.mean(a["params"] == b["params"]) > 0.99
    # and without a seed the port narrows to nearest (no K3)
    seen.clear()
    ptable.apply_gradients(pspec, ps, torch.from_numpy(rows),
                           torch.from_numpy(grads), 2)
    assert seen == []


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_restore_full_rows_and_views_match_jax(dtype):
    jspec, pspec = _specs(dtype)
    js, ps = _random_state(jspec, pspec, 8)
    width = jtiered.state_width(jspec)
    rows = _rows(9, 31)
    vals = np.random.default_rng(9).uniform(
        0.1, 1.0, size=(len(rows), width)).astype(np.float32)
    if dtype == "bf16":   # params a bf16 table can hold
        vals[:, :jspec.dim] = np.asarray(jnp.asarray(
            vals[:, :jspec.dim], jnp.bfloat16).astype(jnp.float32))
    js = jtable.restore_packed_rows(jspec, js, jnp.asarray(rows),
                                    jnp.asarray(vals))
    ptable.restore_packed_rows(pspec, ps, torch.from_numpy(rows),
                               torch.from_numpy(vals))
    _assert_states_equal(ps, js)
    # full_rows reads back what tiered.pack_rows reads, -1 reading zeros
    ok = (rows >= 0) & (rows < CAP)
    ref = jtiered.pack_rows(jspec, _jax_state_np(js), rows[ok])
    out = ptable.full_rows(pspec, ps, torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(out[ok], ref)
    np.testing.assert_array_equal(out[ok], vals[ok])
    assert not out[~ok].any()
    # views and host accessors
    np.testing.assert_array_equal(
        ptable.params_view(pspec, ps).float().numpy(),
        np.asarray(jtable.params_view(jspec, js), np.float32))
    np.testing.assert_array_equal(
        ptable.slot_view(pspec, ps, 1, "norm").numpy(),
        np.asarray(jtable.slot_view(jspec, js, 1, "norm")))
    jitems = jtable.slot_items_np(jspec, js)
    pitems = ptable.slot_items_np(pspec, ps)
    assert [k for k, _ in pitems] == [k for k, _ in jitems]
    for (_, a), (_, b) in zip(pitems, jitems):
        np.testing.assert_array_equal(a, b)
    assert [k for k, _ in ptable.slot_arrays(pspec, ps)] == \
        [k for k, _ in jtable.slot_arrays(jspec, js)]
    np.testing.assert_array_equal(ptable.params_np(pspec, ps),
                                  jtable.params_np(jspec, js))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_state_from_np_structure_of_arrays_matches_jax(dtype):
    """A live prefix of h rows; rows above it are a fresh state's, a slot
    missing from the arrays starts at its init value."""
    jspec, pspec = _specs(dtype)
    rng = np.random.default_rng(4)
    h = 100
    pool = np.asarray(jnp.asarray(rng.normal(size=(h, jspec.dim)),
                                  jspec.dtype).astype(jnp.float32))
    slots = {"seg0/norm": rng.uniform(size=(h, 4)).astype(np.float32)}
    full_pool = np.zeros((1, CAP, jspec.dim), np.float32)
    full_pool[0, :h] = pool
    jslot = {"seg0/norm": np.full((1, CAP, 4), 0.01, np.float32)}
    jslot["seg0/norm"][0, :h] = slots["seg0/norm"]
    js = jtable.state_from_np(jspec, full_pool, jslot, packed=False)
    js = jax.tree.map(lambda x: x[0], js)
    ps = ptable.state_from_np(pspec, pool, slots, "cpu", packed=False)
    _assert_states_equal(ps, js)


def test_zero_rows_matches_jax_engine():
    """Engine.zero_rows on a structure-of-arrays state sets params and
    every slot of the freed rows to 0, as the JAX package's does."""
    jspec, pspec = _specs("bf16")
    js, ps = _random_state(jspec, pspec, 12)
    freed = np.array([0, 5, 77, 300, CAP - 1], np.int64)
    je = JaxEngine([jspec], [], JaxEngineConfig(num_shards=1, packed="off"))
    pe = EmbeddingEngine([pspec], [], EngineConfig(packed="off"),
                         device="cpu")
    jout = je.zero_rows({jspec.name: jax.tree.map(lambda x: x[None], js)},
                        {jspec.name: freed})
    pe.zero_rows({pspec.name: ps}, {pspec.name: freed})
    _assert_states_equal(ps, jax.tree.map(lambda x: x[0], jout[jspec.name]))
    assert not ps["params"][torch.from_numpy(freed)].any()
    assert not ps["slots"][1]["norm"][torch.from_numpy(freed)].any()


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------

def twin_engines(threshold=1, tiered=False, **cfg):
    kw = dict(embedding_dim=4, capacity_per_shard=48,
              admission_threshold=threshold, ttl_seconds=10)
    jtask, ptask = JaxDeepFMTask(**kw), DeepFMTask(**kw)
    cfg = dict(dict(unique_cap=64, new_cap=16), tiered=tiered, **cfg)
    je = JaxEngine(jtask.tables(), jtask.features(),
                   JaxEngineConfig(num_shards=1, **cfg), seed=4)
    pe = EmbeddingEngine(ptask.tables(), ptask.features(),
                         EngineConfig(**cfg), seed=4, device="cpu")
    return je, pe


def random_fids(rng, B=6):
    return {"user_id": rng.integers(-1, 30, (B, 1)).astype(np.int64),
            "item_id": rng.integers(20, 50, (B, 1)).astype(np.int64),
            "hist_items": rng.integers(-1, 50, (B, 10)).astype(np.int64)}


CHANNELS = [(dict(packed="off"), "new_pos", np.int16),
            (dict(packed="off", compact_wire=False), "new_rows", np.int32),
            (dict(compact_wire=False), "new_mask", np.uint8)]


@pytest.mark.parametrize("threshold", [1, 2])
@pytest.mark.parametrize("cfg,channel,dtype", CHANNELS,
                         ids=["soa-compact", "soa-int32", "packed-int32"])
def test_prepare_batch_channels_match_jax(cfg, channel, dtype, threshold):
    """Every step's rows, new-row channel (values and dtype) and index
    values equal JAX's prepare_batch; the stats too. Without compact and
    without admission the JAX package maps with `map_train`, with
    admission with `map_train_pos`: the host stores end equal either
    way."""
    je, pe = twin_engines(threshold, **cfg)
    rng = np.random.default_rng(threshold)
    for step in range(8):
        fb = random_fids(rng)
        jin, js = je.prepare_batch(fb, ts=step)
        pin, ps = pe.prepare_batch(fb, ts=step)
        j, p = jin["sparse"], pin["sparse"]
        assert set(p) == {"rows", channel, "index"} and channel in j
        np.testing.assert_array_equal(p["rows"], j["rows"][0])
        assert p[channel].dtype == j[channel].dtype == dtype
        np.testing.assert_array_equal(p[channel], j[channel][0])
        for f in j["index"]:
            assert j["index"][f].dtype == (np.int16 if cfg.get(
                "compact_wire", True) else np.int32)
            np.testing.assert_array_equal(p["index"][f],
                                          j["index"][f].astype(np.int32))
        assert ps == js
    for a, b in zip(pe.stores["sparse"].save(),
                    je.stores["sparse"][0].save()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compact", [True, False])
def test_prepare_batch_revive_rows_match_jax(compact):
    """A tiered structure-of-arrays engine revives by row: the first n
    "revive_rows" and values equal JAX's, the rest of the port's
    power-of-two array is -1."""
    je, pe = twin_engines(1, tiered=True, packed="off", compact_wire=compact)
    width = jtiered.state_width(je.tables["sparse"])
    rng = np.random.default_rng(5)
    revived = 0
    for step in range(12):
        fb = random_fids(rng)
        jin, js = je.prepare_batch(fb, ts=step * 4)
        pin, ps = pe.prepare_batch(fb, ts=step * 4)
        j, p = jin["sparse"], pin["sparse"]
        assert "revive_pos" not in p and "revive_pos" not in j
        n = int((j["revive_rows"][0] >= 0).sum())
        m = len(p["revive_rows"])
        assert m == (0 if n == 0 else 1 << (n - 1).bit_length())
        np.testing.assert_array_equal(p["revive_rows"][:n],
                                      j["revive_rows"][0, :n])
        assert (p["revive_rows"][n:] == -1).all()
        np.testing.assert_array_equal(p["revive_values"][:n],
                                      j["revive_values"][0, :n])
        assert p["revive_values"].shape == (m, width)
        assert ps == js
        revived += n
        if step % 3 == 2:
            jr, jf = je.stores["sparse"][0].evict_expired(step * 4 - 6,
                                                          return_fids=True)
            pr, pf = pe.stores["sparse"].evict_expired(step * 4 - 6,
                                                      return_fids=True)
            np.testing.assert_array_equal(pf, jf)
            vals = (pf[:, None] * 0.5 + np.arange(width)).astype(np.float32)
            je.archives["sparse"][0].spill(jf, vals, ts=step)
            pe.archives["sparse"].spill(pf, vals, ts=step)
    assert revived > 0


GRID = [dict(packed=p, compact_wire=c, unique_cap=u, tiered=t)
        for p in ("auto", "off") for c in (True, False)
        for u in (4096, 65535, 65536) for t in (False, True)]


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_fuse_wire_matches_jax_over_a_grid(table_dtype):
    jd, pd = DTYPES[table_dtype]
    kw = dict(num_tables=2, num_slots=3, embedding_dim=4,
              capacity_per_shard=64, merge=True)
    jtask = JaxMultiSlotTask(table_dtype=jd, **kw)
    ptask = MultiSlotTask(table_dtype=pd, **kw)
    for cfg in GRID:
        je = JaxEngine(jtask.tables(), jtask.features(),
                       JaxEngineConfig(num_shards=1, **cfg))
        pe = EmbeddingEngine(ptask.tables(), ptask.features(),
                             EngineConfig(**cfg), device="cpu")
        # the JAX package sends a cap above 65535 to its multi-array
        # path; the port's wire carries it as a wide table
        wide = (pe.wire_capable and not cfg["tiered"]
                and cfg["unique_cap"] > 65535)
        assert pe.fuse_wire == (je.fuse_wire or wide), cfg
        assert not (je.fuse_wire and wide), cfg
        assert pe.packed == je.packed, cfg
        assert pe.config.index_dtype == je.config.index_dtype, cfg
        assert pe.config.pos_dtype == je.config.pos_dtype, cfg
    # per-table caps count too: the table above 65535 is wide, the
    # others keep 16-bit index words
    cfg = dict(unique_caps=(("merged_0", 70000),))
    pe = EmbeddingEngine(ptask.tables(), ptask.features(),
                         EngineConfig(**cfg), device="cpu")
    assert pe.fuse_wire and pe.wide("merged_0")
    assert not any(pe.wide(t) for t in pe.tables if t != "merged_0")
    with pytest.raises(ValueError, match="packed"):
        EmbeddingEngine(ptask.tables(), ptask.features(),
                        EngineConfig(packed="on"), device="cpu")


@pytest.mark.parametrize("cfg", [dict(packed="off"), dict(compact_wire=False),
                                 dict(unique_cap=70000, new_cap=70000)],
                         ids=["soa", "int32", "cap70000"])
def test_prepare_wire_refuses_what_the_wire_cannot_carry(cfg):
    """Without compact_wire both packages refuse; the port refuses a
    structure-of-arrays engine too (the JAX package's prepare_wire packs
    a wire that its multi-array step never reads). Above 65535 the JAX
    package refuses and the port packs a wide table: int32 index words,
    the wire `pack_wire` lays from prepare_batch's arrays."""
    je, pe = twin_engines(**cfg)
    fb = random_fids(np.random.default_rng(0))
    assert not je.fuse_wire
    if cfg.get("unique_cap") == 70000:
        with pytest.raises(ValueError, match="65535"):
            je.prepare_wire(fb, ts=0)
        _, twin = twin_engines(**cfg)
        assert pe.fuse_wire and pe.wide("sparse")
        wire, _ = pe.prepare_wire(fb, ts=0)
        inputs, _ = twin.prepare_batch(fb, ts=0)
        np.testing.assert_array_equal(wire, twin.pack_wire(inputs))
        assert wire.size == pe.wire_words(6) == 70000 + 6 * (1 + 1 + 10)
        return
    assert not pe.fuse_wire
    for eng in (je, pe) if cfg.get("packed") != "off" else (pe,):
        with pytest.raises(ValueError, match="prepare_wire requires"):
            eng.prepare_wire(fb, ts=0)


@pytest.mark.parametrize("cfg", [dict(packed="off"),
                                 dict(packed="off", compact_wire=False),
                                 dict(compact_wire=False),
                                 dict(unique_cap=70000, new_cap=70000)],
                         ids=["soa", "soa-int32", "int32", "cap70000"])
def test_pack_and_decode_arrays_round_trip(cfg):
    """pack_arrays -> decode_arrays gives prepare_batch's arrays back, as
    int32 on the device (a packed table's mask through bit 30)."""
    _, pe = twin_engines(**cfg)
    rng = np.random.default_rng(3)
    for step in range(4):
        inputs, _ = pe.prepare_batch(random_fids(rng, B=5), ts=step)
        words = np.empty(pe.array_words(5), np.int32)
        pe.pack_arrays(inputs, words)
        out = pe.decode_arrays(torch.from_numpy(words), 5)
        for tname, tin in inputs.items():
            assert set(out[tname]) == set(tin)
            for k, v in tin.items():
                if k == "index":
                    for f in v:
                        np.testing.assert_array_equal(
                            out[tname][k][f].numpy(), v[f])
                else:
                    np.testing.assert_array_equal(out[tname][k].numpy(), v)
    with pytest.raises(ValueError, match="words"):
        pe.pack_arrays(inputs, np.empty(pe.array_words(5) + 1, np.int32))


# ----------------------------------------------------------------------
# trainer
# ----------------------------------------------------------------------

TASK = dict(capacity_per_shard=4096, hidden=(32, 16), init_scale=0.0)
B = 64
TRAINERS = {"soa": dict(packed="off", unique_cap=512, new_cap=512),
            "soa-int32": dict(packed="off", compact_wire=False,
                              unique_cap=512, new_cap=256),
            "int32": dict(compact_wire=False, unique_cap=512, new_cap=512),
            "cap70000": dict(unique_cap=70000, new_cap=70000)}


def _jax_config(**engine):
    return JaxTrainerConfig(engine=JaxEngineConfig(num_shards=1, **engine),
                            log_every=0)


def _twins(**engine):
    jcfg = _jax_config(**engine)
    jt = JaxTrainer(JaxDeepFMTask(**TASK), jcfg)
    pt = Trainer(DeepFMTask(**TASK), convert.port_trainer_config(jcfg),
                 device="cpu")
    return jt, pt


def _batches(n, seed=11):
    data = JaxSyntheticCTR(num_users=400, num_items=300, batch_size=B,
                           seed=seed)
    return [data.batch() for _ in range(n)]


def _assert_tables_close(pstate, jstate, rtol, atol):
    for tname, jv in jstate["tables"].items():
        pv = pstate["tables"][tname]
        if isinstance(jv, dict):
            assert isinstance(pv, dict)
            np.testing.assert_allclose(pv["params"], jv["params"], rtol=rtol,
                                       atol=atol)
            for i, seg in enumerate(jv["slots"]):
                for name in seg:
                    np.testing.assert_allclose(pv["slots"][i][name],
                                               seg[name], rtol=rtol,
                                               atol=atol)
        else:
            np.testing.assert_allclose(pv, jv, rtol=rtol, atol=atol)


@pytest.fixture(scope="module", params=sorted(TRAINERS))
def trained(request):
    """3 JAX steps, the state carried across, then 3 steps in each package
    on the same batches and timestamps, and 2 eval batches."""
    jt, pt = _twins(**TRAINERS[request.param])
    batches = _batches(8)
    for i in range(3):
        jt.train_step(*batches[i], ts=500 + i)
    convert.load_state(pt, convert.jax_trainer_state(jt))
    outs = []
    for i in range(3, 6):
        jo = jt.train_step(*batches[i], ts=500 + i)
        po = pt.train_step(*batches[i], ts=500 + i)
        outs.append((jo, po))
    return request.param, jt, pt, outs, (jt.evaluate(iter(batches[6:8])),
                                         pt.evaluate(iter(batches[6:8])))


def test_trainer_takes_the_multi_array_path(trained):
    """Every configuration takes the JAX package's multi-array path; the
    port's takes it too, but at a cap of 70000, which its wire carries as
    a wide table."""
    name, jt, pt, *_ = trained
    assert not jt.engine.fuse_wire
    assert pt.engine.fuse_wire == (name == "cap70000")
    assert pt.engine.packed == jt.engine.packed == (not name.startswith("soa"))
    st = pt.table_states["sparse"]
    if name.startswith("soa"):
        assert set(st) == {"params", "slots"}
        assert st["params"].shape == (TASK["capacity_per_shard"], 17)
    else:
        assert set(st) == {"data"}


def test_trainer_steps_match_jax(trained):
    _, jt, pt, outs, (jev, pev) = trained
    for jo, po in outs:
        np.testing.assert_allclose(po["loss"].numpy(), np.asarray(jo["loss"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(po["preds"].numpy(),
                                   np.asarray(jo["preds"]), rtol=1e-5,
                                   atol=1e-6)
        assert po["stats"] == jo["stats"]
    assert abs(pev["auc"] - jev["auc"]) <= 1e-6
    np.testing.assert_allclose(pev["loss"], jev["loss"], rtol=1e-5)


def test_trainer_state_matches_jax(trained):
    _, jt, pt, *_ = trained
    jstate, pstate = convert.jax_trainer_state(jt), convert.export_state(pt)
    _assert_tables_close(pstate, jstate, rtol=0, atol=1e-5)
    for tree in ("params", "opt_state"):
        ref = convert._to_module_tensors(jstate[tree])
        out = convert._to_module_tensors(pstate[tree])
        for k in ref:
            np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-5)
    for a, b in zip(pstate["stores"]["sparse"], jstate["stores"]["sparse"]):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))


def test_multi_array_path_steps_one_by_one():
    """Off the fused wire train(steps_per_dispatch=4) steps one by one,
    equal to train_step bit for bit, and an explicit block is refused."""
    _, a = _twins(packed="off", unique_cap=512, new_cap=512)
    _, b = _twins(packed="off", unique_cap=512, new_cap=512)
    b.config.steps_per_dispatch = 4
    batches = _batches(6, seed=3)
    assert not b._block_capable()
    for fb, bt in batches:
        a.train_step(fb, bt, ts=7)
    import monolith_tpu_torch.training.trainer as trainer_mod
    real = trainer_mod.time.time
    trainer_mod.time.time = lambda: 7
    try:
        b.train(iter(batches))
    finally:
        trainer_mod.time.time = real
    assert a.step == b.step == 6
    sa, sb = a.table_states["sparse"], b.table_states["sparse"]
    assert torch.equal(sa["params"], sb["params"])
    assert torch.equal(sa["slots"][1]["norm"], sb["slots"][1]["norm"])
    with pytest.raises(ValueError, match="one by one"):
        b.train_step_block(batches[:2], ts=8)


def test_soa_bf16_multislot_trains_and_rounds_once_a_step():
    """A bf16 structure-of-arrays multislot table with stochastic rounding:
    one K3 call a table a step (the plain version on the CPU, counted
    here), f32 slots, finite falling loss on repeated batches, and params
    that stay bf16."""
    task = MultiSlotTask(num_tables=4, num_slots=10, embedding_dim=8,
                         capacity_per_shard=8192, history_length=6,
                         hidden=(32,), merge=True, table_dtype=torch.bfloat16,
                         stochastic_rounding=True)
    from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
    from monolith_tpu_torch.training.trainer import TrainerConfig
    pt = Trainer(task, TrainerConfig(engine=EngineConfig(
        unique_cap=2048, new_cap=2048, packed="off"), log_every=0),
        device="cpu")
    data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                              history_length=6, batch_size=256, seed=1)
    batches = [data.batch() for _ in range(3)]
    calls = []
    real = ptable.stochastic_round_bf16

    def counted(x, seed):
        calls.append(seed)
        return real(x, seed)
    ptable.stochastic_round_bf16 = counted
    try:
        losses = [float(pt.train_step(*batches[i % 3], ts=i)["loss"])
                  for i in range(9)]
    finally:
        ptable.stochastic_round_bf16 = real
    ntables = len(pt.engine.tables)
    assert len(calls) == 9 * ntables and len(set(calls)) == len(calls)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for st in pt.table_states.values():
        assert st["params"].dtype == torch.bfloat16
        assert all(a.dtype == torch.float32 for seg in st["slots"]
                   for a in seg.values())


# ----------------------------------------------------------------------
# checkpoints and convert across layouts and packages
# ----------------------------------------------------------------------

def _trained_jax(packed, steps=3):
    jt = JaxTrainer(JaxDeepFMTask(**TASK), _jax_config(
        packed=packed, unique_cap=512, new_cap=512))
    for i, pair in enumerate(_batches(steps, seed=21)):
        jt.train_step(*pair, ts=100 + i)
    return jt


def _port(packed):
    return Trainer(DeepFMTask(**TASK), convert.port_trainer_config(
        _jax_config(packed=packed, unique_cap=512, new_cap=512)),
        device="cpu")


def _params_and_norm(state):
    """(params [cap, dim], Adagrad norm [cap, 16]) of an exported table in
    either layout."""
    v = state["tables"]["sparse"]
    if isinstance(v, dict):
        return v["params"][0], v["slots"][1]["norm"][0]
    jspec = JaxDeepFMTask(**TASK).tables()[0]
    off, k, _ = jtable._layout(jspec)[2][(1, "norm")]
    return v[0][:, :jspec.dim], v[0][:, off:off + k]


@pytest.mark.parametrize("src,dst", [("off", "auto"), ("auto", "off"),
                                     ("off", "off")])
def test_jax_checkpoint_restores_into_either_layout(tmp_path, src, dst):
    jt = _trained_jax(src)
    jckpt.save(jt, str(tmp_path))
    pt = _port(dst)
    assert pckpt.restore(pt, str(tmp_path)) == 3
    assert ("data" in pt.table_states["sparse"]) == (dst == "auto")
    jp, jn = _params_and_norm(convert.jax_trainer_state(jt))
    pp, pn = _params_and_norm(convert.export_state(pt))
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pn, jn)


@pytest.mark.parametrize("src,dst", [("off", "auto"), ("off", "off"),
                                     ("auto", "off")])
def test_port_checkpoint_restores_into_either_layout_and_jax(tmp_path, src,
                                                             dst):
    """A port trainer's checkpoint, in one layout, restores into a port
    trainer of the other (and the next step agrees) and into the JAX
    trainer of `dst`'s layout."""
    jt = _trained_jax(src)
    pt = _port(src)
    convert.load_state(pt, convert.jax_trainer_state(jt))
    pckpt.save(pt, str(tmp_path))
    back = _port(dst)
    pckpt.restore(back, str(tmp_path))
    pp, pn = _params_and_norm(convert.export_state(pt))
    bp, bn = _params_and_norm(convert.export_state(back))
    np.testing.assert_array_equal(bp, pp)
    np.testing.assert_array_equal(bn, pn)
    pair = _batches(1, seed=22)[0]
    np.testing.assert_allclose(
        float(back.train_step(*pair, ts=200)["loss"]),
        float(pt.train_step(*pair, ts=200)["loss"]), rtol=1e-6)
    jb = JaxTrainer(JaxDeepFMTask(**TASK), _jax_config(
        packed=dst, unique_cap=512, new_cap=512))
    jb.train_step(*_batches(1, seed=21)[0], ts=100)   # builds params
    jckpt.restore(jb, os.path.join(str(tmp_path)))
    jp, jn = _params_and_norm(convert.jax_trainer_state(jb))
    np.testing.assert_array_equal(jp, pp)
    np.testing.assert_array_equal(jn, pn)


def test_convert_carries_a_state_across_layouts():
    """A JAX structure-of-arrays state loads into a packed port trainer
    and a packed one into a structure-of-arrays port trainer; export_state
    reads each back in its own layout with the same values."""
    for src, dst in (("off", "auto"), ("auto", "off")):
        jt = _trained_jax(src)
        pt = _port(dst)
        convert.load_state(pt, convert.jax_trainer_state(jt))
        jp, jn = _params_and_norm(convert.jax_trainer_state(jt))
        pp, pn = _params_and_norm(convert.export_state(pt))
        np.testing.assert_array_equal(pp, jp)
        np.testing.assert_array_equal(pn, jn)
        assert isinstance(convert.export_state(pt)["tables"]["sparse"],
                          dict) == (dst == "off")


# ----------------------------------------------------------------------
# tiered structure-of-arrays trainer against JAX's
# ----------------------------------------------------------------------

def test_tiered_soa_train_spill_revive_train_matches_jax():
    """A tiered structure-of-arrays DeepFM: train -> spill (the archived
    rows are params then slots, `full_rows`) -> other ids take the freed
    rows, which read zero in params and in every slot -> the spilled ids
    revive with their exact state (restore_packed_rows at "revive_rows")
    -> train: losses, tables, stores and archives equal JAX's at every
    stage (tests/test_torch_tiered.py's criteria)."""
    from test_torch_tiered import both_archives_equal, ids_batch, step_both
    from test_torch_tiered import twins as tiered_twins
    jt, pt = tiered_twins(packed="off")
    assert not pt.engine.packed and not pt.engine.wire_capable

    def tables_equal():
        js, ps = convert.jax_trainer_state(jt), convert.export_state(pt)
        _assert_tables_close(ps, js, rtol=0, atol=1e-6)
        for a, b in zip(js["stores"]["sparse"], ps["stores"]["sparse"]):
            np.testing.assert_array_equal(np.sort(a), np.sort(b))

    fb = ids_batch(np.arange(1, 9))
    for _ in range(3):
        step_both(jt, pt, fb, ts=100)
    tables_equal()
    rows = pt.engine.stores["sparse"].lookup(fb[0]["user_id"].ravel())
    assert pt.spill_expired(200) == jt.spill_expired(200) == {"sparse": 16}
    both_archives_equal(jt, pt)
    tables_equal()
    st = pt.table_states["sparse"]
    idx = torch.from_numpy(rows).long()
    assert not st["params"][idx].any()
    assert not st["slots"][1]["norm"][idx].any()
    step_both(jt, pt, ids_batch(np.arange(1000, 1008)), ts=300)
    tables_equal()
    step_both(jt, pt, fb, ts=400)                    # the revive
    assert pt.engine.archives["sparse"].revived == 16
    both_archives_equal(jt, pt)
    tables_equal()
    step_both(jt, pt, fb, ts=500)
    tables_equal()
