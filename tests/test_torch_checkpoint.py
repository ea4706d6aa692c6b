"""Checkpoints cross the two packages: a checkpoint (full, dense-only or
delta) written by the JAX package restores in the port and the reverse, on
the CPU.

Small DeepFM (dim 8, capacity 4096, hidden (16, 8), unique_cap 512, batch
128, 80 users x 40 items), inputs made from a seed with numpy. Restored
state is compared exactly (pools, host stores, step, dense parameters and
accumulators: the files carry f32 values and both readers copy them).
Steps after a restore are compared at the trainer tests' tolerance (losses
rtol 1e-5 / atol 1e-6: f32 sums in another order); they run on batches whose
ids the checkpointed steps had admitted, so that neither package draws a
new row's init there (their PRNGs differ). The 8-shard case holds every
fid's params and slots exactly and the eval AUC within 1e-5.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from monolith_tpu.embedding import table as jtable
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

TASK = dict(embedding_dim=8, capacity_per_shard=4096, hidden=(16, 8))
U, B = 512, 128


def jax_trainer(seed=51, **task):
    tr = JaxTrainer(JaxDeepFMTask(**{**TASK, **task}), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=U, new_cap=U),
        log_every=0, seed=seed))
    return tr


def jax_ready(tr, pair):
    """The JAX trainer builds its dense params at its first prepare; a
    restore needs them as a template."""
    inputs, _ = tr.engine.prepare_batch(pair[0], ts=0)
    tr._maybe_init(inputs, pair[1])
    return tr


def port_trainer(seed=51, **task):
    return Trainer(DeepFMTask(**{**TASK, **task}), TrainerConfig(
        engine=EngineConfig(unique_cap=U, new_cap=U), log_every=0, seed=seed),
        device="cpu")


def batches(n, seed=51):
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=B, seed=seed)
    return [data.batch() for _ in range(n)]


def seen_again(pairs, seed):
    """Batches of the same ids in other pairings with new labels: no id is
    new to a trainer that has stepped through `pairs`."""
    rng = np.random.default_rng(seed)
    out = []
    for fb, b in pairs:
        out.append(({k: np.roll(v, i + 1, axis=0)
                     for i, (k, v) in enumerate(sorted(fb.items()))},
                    {"label": rng.integers(0, 2, B).astype(np.float32),
                     "hist_len": b["hist_len"]}))
    return out


def assert_states_equal(a, b):
    """Two states in convert.py's numpy format, exactly; the stores'
    entries in fid order (a dump's order is the map's own)."""
    for tree in ("params", "opt_state"):
        x, y = (convert._to_module_tensors(s[tree]) for s in (a, b))
        assert sorted(x) == sorted(y)
        for name in x:
            np.testing.assert_array_equal(x[name], y[name], err_msg=name)
    assert sorted(a["tables"]) == sorted(b["tables"])
    for t in a["tables"]:
        np.testing.assert_array_equal(
            np.asarray(a["tables"][t]).reshape(np.shape(b["tables"][t])),
            b["tables"][t], err_msg=t)
        sa, sb = a["stores"][t], b["stores"][t]
        oa, ob = np.argsort(sa[0]), np.argsort(sb[0])
        for col_a, col_b in zip(sa, sb):
            np.testing.assert_array_equal(col_a[oa], col_b[ob])
            assert col_a.dtype == col_b.dtype
    assert a["step"] == b["step"]


# ----------------------------------------------------------------------
# (a) JAX save -> port restore; (b) port save -> JAX restore
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_to_port(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    pairs = batches(5)
    jt = jax_trainer()
    for i, p in enumerate(pairs):
        jt.train_step(*p, ts=100 + i)
    path = jckpt.save(jt, d)
    pt = port_trainer(seed=3)          # other dense weights than the file's
    step = pckpt.restore(pt, d)
    return jt, pt, path, step, pairs


def test_jax_checkpoint_restores_in_the_port_exactly(jax_to_port):
    jt, pt, _, step, _ = jax_to_port
    assert step == pt.step == jt.step == 5
    assert_states_equal(convert.export_state(pt),
                        convert.jax_trainer_state(jt))


@pytest.mark.parametrize("i", range(2))
def test_steps_after_a_jax_checkpoint_match(jax_to_port, i):
    jt, pt, _, _, pairs = jax_to_port
    if not hasattr(test_steps_after_a_jax_checkpoint_match, "outs"):
        outs = []
        for k, p in enumerate(seen_again(pairs[:2], seed=1)):
            jo = jt.train_step(*p, ts=200 + k)
            po = pt.train_step(*p, ts=200 + k)
            assert not any(po["stats"]["new"].values())
            outs.append((np.asarray(jo["loss"]), po["loss"].numpy(),
                         np.asarray(jo["preds"]), po["preds"].numpy()))
        test_steps_after_a_jax_checkpoint_match.outs = outs
    jl, pl, jp, pp = test_steps_after_a_jax_checkpoint_match.outs[i]
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def port_to_jax(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_ckpt"))
    pairs = batches(5, seed=52)
    pt = port_trainer()
    for i, p in enumerate(pairs):
        pt.train_step(*p, ts=100 + i)
    path = pckpt.save(pt, d)
    jt = jax_ready(jax_trainer(seed=3), pairs[0])
    step = jckpt.restore(jt, d)
    return pt, jt, path, step, pairs


def test_port_checkpoint_restores_in_jax_exactly(port_to_jax):
    pt, jt, _, step, _ = port_to_jax
    assert step == int(jt.step) == pt.step == 5
    assert_states_equal(convert.jax_trainer_state(jt),
                        convert.export_state(pt))


@pytest.mark.parametrize("i", range(2))
def test_steps_after_a_port_checkpoint_match(port_to_jax, i):
    pt, jt, _, _, pairs = port_to_jax
    if not hasattr(test_steps_after_a_port_checkpoint_match, "outs"):
        outs = []
        for k, p in enumerate(seen_again(pairs[:2], seed=2)):
            jo = jt.train_step(*p, ts=200 + k)
            po = pt.train_step(*p, ts=200 + k)
            outs.append((np.asarray(jo["loss"]), po["loss"].numpy()))
        test_steps_after_a_port_checkpoint_match.outs = outs
    jl, pl = test_steps_after_a_port_checkpoint_match.outs[i]
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-6)


def _listing(path):
    out = []
    for root, _, files in os.walk(path):
        out += [os.path.relpath(os.path.join(root, f), path) for f in files]
    return sorted(out)


def test_both_packages_write_the_same_layout(jax_to_port, port_to_jax):
    """Same files, same npz members with the same dtypes, same meta keys;
    the pool is the live prefix; opt_state.msgpack is optax.adagrad's
    tree."""
    jpath, ppath = jax_to_port[2], port_to_jax[2]
    assert _listing(ppath) == _listing(jpath) == [
        "dense.msgpack", "meta.json", "opt_state.msgpack",
        "tables/sparse-s0.npz"]
    jz = np.load(os.path.join(jpath, "tables", "sparse-s0.npz"))
    pz = np.load(os.path.join(ppath, "tables", "sparse-s0.npz"))
    assert sorted(pz.files) == sorted(jz.files) == sorted([
        "pool", "fids", "rows", "tss", "counts", "slot:seg1/norm"])
    for k in jz.files:
        assert pz[k].dtype == jz[k].dtype and pz[k].ndim == jz[k].ndim, k
    hw = int(pz["rows"].max()) + 1
    assert pz["pool"].shape == (hw, 9) and hw < 4096
    assert pz["slot:seg1/norm"].shape == (hw, 8)
    jm, pm = (json.load(open(os.path.join(p, "meta.json")))
              for p in (jpath, ppath))
    assert sorted(pm) == sorted(jm)
    assert pm["tables"] == jm["tables"] == {"sparse": {"shards": 1, "dim": 9}}
    assert pm["dense_only"] is False and pm["step"] == 5
    from monolith_tpu_torch import serialization
    for path in (jpath, ppath):
        opt = serialization.msgpack_restore(
            open(os.path.join(path, "opt_state.msgpack"), "rb").read())
        assert sorted(opt) == ["0", "1"] and opt["1"] == {}
        assert sorted(opt["0"]) == ["sum_of_squares"]
        assert sorted(opt["0"]["sum_of_squares"]["deep"]) == [
            "dense_0", "dense_1", "dense_2"]


def test_dense_files_equal_flax_bytes(port_to_jax):
    """The port's dense.msgpack and opt_state.msgpack are what flax writes
    for the JAX trainer that restored them."""
    from flax import serialization as fser
    _, jt2, path, _, pairs = port_to_jax
    jt = jax_ready(jax_trainer(seed=4), pairs[0])
    jckpt.restore(jt, os.path.dirname(path))
    for name, tree in (("dense.msgpack", jt.params),
                       ("opt_state.msgpack", jt.opt_state)):
        with open(os.path.join(path, name), "rb") as f:
            assert f.read() == fser.to_bytes(jax.device_get(tree)), name


# ----------------------------------------------------------------------
# (c) port save -> port restore, with an admission filter
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_port_round_trip_is_bit_exact_and_keeps_the_filter(tmp_path, dtype):
    task = dict(admission_threshold=3, table_dtype=dtype,
                stochastic_rounding=dtype == torch.bfloat16)
    data = SyntheticCTR(num_users=300, num_items=200, batch_size=B, seed=8)
    pairs = [data.batch() for _ in range(8)]
    a = port_trainer(**task)
    for i, p in enumerate(pairs[:6]):
        a.train_step(*p, ts=100 + i)
    path = pckpt.save(a, str(tmp_path))
    assert os.path.exists(os.path.join(path, "filters", "sparse-s0.bin"))
    assert pckpt.latest_step(str(tmp_path)) == 6
    b = port_trainer(**task)   # the same seed: the same new-row init later
    with torch.no_grad():
        for p in b.module.parameters():
            p.add_(1.0)        # restore must overwrite the dense side too
    assert pckpt.restore(b, str(tmp_path)) == 6
    assert b.table_states["sparse"]["data"].dtype == dtype
    assert torch.equal(a.table_states["sparse"]["data"],
                       b.table_states["sparse"]["data"])
    assert_states_equal(convert.export_state(a), convert.export_state(b))
    fa = a.engine.stores["sparse"].filter_save()
    assert len(fa) > 0 and fa == b.engine.stores["sparse"].filter_save()
    with open(os.path.join(path, "filters", "sparse-s0.bin"), "rb") as f:
        assert f.read() == fa
    # the filter's counts decide the next admissions: same stats, same bits
    for i, p in enumerate(pairs[6:]):
        oa, ob = a.train_step(*p, ts=300 + i), b.train_step(*p, ts=300 + i)
        assert oa["stats"] == ob["stats"]
        assert oa["stats"]["filtered"]["sparse"] > 0
        assert torch.equal(oa["loss"], ob["loss"])
    assert torch.equal(a.table_states["sparse"]["data"],
                       b.table_states["sparse"]["data"])


def test_jax_f32_checkpoint_into_a_bf16_port_trainer_is_a_plain_cast(
        jax_to_port):
    jt, _, path, _, _ = jax_to_port
    pt = port_trainer(table_dtype=torch.bfloat16)
    pckpt.restore(pt, os.path.dirname(path), step=5)
    pool = pt.table_states["sparse"]["data"]
    assert pool.dtype == torch.bfloat16
    assert tuple(pool.shape) == jt.table_states["sparse"]["data"].shape[1:]
    # the JAX trainer has stepped on since the save: compare the file
    z = np.load(os.path.join(path, "tables", "sparse-s0.npz"))
    hw = z["pool"].shape[0]
    assert torch.equal(pool[:hw, :9],
                       torch.from_numpy(z["pool"]).to(torch.bfloat16))
    assert torch.equal(pool[hw:], ptable.create_state(
        pt.engine.tables["sparse"], "cpu")["data"][hw:])


def test_restore_errors(tmp_path, jax_to_port):
    pt = port_trainer()
    with pytest.raises(FileNotFoundError, match="no CHECKPOINT"):
        pckpt.restore(pt, str(tmp_path))
    assert pckpt.latest_step(str(tmp_path)) is None
    # another tower: the dense file's names or shapes do not fit
    other = port_trainer(hidden=(16,))
    with pytest.raises(ValueError, match="keys differ"):
        pckpt.restore(other, os.path.dirname(jax_to_port[2]))
    wide = port_trainer(hidden=(32, 8))
    with pytest.raises(ValueError, match="shape"):
        pckpt.restore(wide, os.path.dirname(jax_to_port[2]))
    small = port_trainer(capacity_per_shard=64)
    with pytest.raises(ValueError, match="capacity_per_shard"):
        pckpt.restore(small, os.path.dirname(jax_to_port[2]))


# ----------------------------------------------------------------------
# (d) an 8-shard JAX checkpoint folds into the port's one shard
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    from monolith_tpu.parallel import ShardedTrainer, make_mesh
    d = str(tmp_path_factory.mktemp("sharded_ckpt"))
    data = SyntheticCTR(num_users=150, num_items=80, batch_size=64, seed=9)
    tr8 = ShardedTrainer(
        JaxDeepFMTask(**{**TASK, "capacity_per_shard": 2048}),
        JaxTrainerConfig(engine=JaxEngineConfig(num_shards=8, unique_cap=512,
                                                new_cap=512), log_every=0),
        make_mesh(8))
    for _ in range(15):
        tr8.train_step(*data.batch())
    ev8 = tr8.evaluate(iter(SyntheticCTR(num_users=150, num_items=80,
                                         batch_size=64, seed=9)), max_steps=8)
    jckpt.save(tr8, d)
    pt = port_trainer()
    step = pckpt.restore(pt, d)
    return tr8, ev8, pt, step, d


def test_sharded_checkpoint_keeps_every_fid(sharded):
    tr8, _, pt, step, d = sharded
    assert step == pt.step == 15
    with open(os.path.join(d, "ckpt-15", "meta.json")) as f:
        assert json.load(f)["tables"]["sparse"]["shards"] == 8
    spec, jspec = pt.engine.tables["sparse"], tr8.engine.tables["sparse"]
    store = pt.engine.stores["sparse"]
    live = {"data": pt.table_states["sparse"]["data"]}
    p_params = ptable.params_np(spec, live)
    p_slots = dict(ptable.slot_items_np(spec, live))
    total = 0
    for s, jstore in enumerate(tr8.engine.stores["sparse"]):
        fids, rows, tss, counts = jstore.save()
        total += len(fids)
        shard = jax.tree.map(lambda x: np.asarray(x[s]),
                             tr8.table_states["sparse"])
        prow = store.lookup(fids)
        assert (prow >= 0).all()
        np.testing.assert_array_equal(
            p_params[prow], jtable.params_np(jspec, shard)[rows])
        for name, arr in jtable.slot_items_np(jspec, shard):
            np.testing.assert_array_equal(p_slots[name][prow], arr[rows])
    assert total == store.size() > 200
    # rows renumbered 0..n-1, the rest of the pool fresh
    pf, pr, _, _ = store.save()
    assert sorted(pr.tolist()) == list(range(total))
    fresh = ptable.create_state(spec, "cpu")["data"]
    assert torch.equal(pt.table_states["sparse"]["data"][total:],
                       fresh[total:])


def test_sharded_checkpoint_keeps_timestamps_and_counts(sharded):
    tr8, _, pt, _, _ = sharded
    want = {}
    for jstore in tr8.engine.stores["sparse"]:
        fids, _, tss, counts = jstore.save()
        want.update({int(f): (int(t), int(c))
                     for f, t, c in zip(fids, tss, counts)})
    fids, _, tss, counts = pt.engine.stores["sparse"].save()
    got = {int(f): (int(t), int(c)) for f, t, c in zip(fids, tss, counts)}
    assert got == want


def test_sharded_checkpoint_eval_auc(sharded):
    _, ev8, pt, _, _ = sharded
    ev = pt.evaluate(iter(SyntheticCTR(num_users=150, num_items=80,
                                       batch_size=64, seed=9)), max_steps=8)
    assert abs(ev["auc"] - ev8["auc"]) <= 1e-5
    np.testing.assert_allclose(ev["loss"], ev8["loss"], rtol=1e-4)


def test_sharded_checkpoint_overflow_raises(sharded):
    d = sharded[4]
    with pytest.raises(ValueError, match="capacity_per_shard"):
        pckpt.restore(port_trainer(capacity_per_shard=16), d)


# ----------------------------------------------------------------------
# (e) deltas, both ways
# ----------------------------------------------------------------------

def _params_of(trainer, fids):
    """[n, dim] params of `fids` in either package's trainer (f32)."""
    if isinstance(trainer, Trainer):
        rows = trainer.engine.stores["sparse"].lookup(fids)
        pool = ptable.params_np(trainer.engine.tables["sparse"],
                                trainer.table_states["sparse"])
    else:
        rows = trainer.engine.stores["sparse"][0].lookup(fids)
        pool = jtable.params_np(
            trainer.engine.tables["sparse"],
            jax.tree.map(lambda x: np.asarray(x[0]),
                         trainer.table_states["sparse"]))
    assert (rows >= 0).all()
    return pool[rows]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_delta_crosses_the_packages(tmp_path, direction, dtype):
    """Two trainers share a base state; the writer steps on (some ids new,
    some old), saves the rows touched since; the reader applies them: the
    touched fids' params then equal the writer's exactly, untouched rows
    keep theirs, new ids are admitted with fresh slots."""
    import jax.numpy as jnp
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    pdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    pairs = batches(3, seed=61)
    later = SyntheticCTR(num_users=120, num_items=60, batch_size=B, seed=62)
    more = [later.batch() for _ in range(2)]
    jt = jax_trainer(table_dtype=jdt)
    for i, p in enumerate(pairs):
        jt.train_step(*p, ts=100 + i)
    pt = port_trainer(table_dtype=pdt)
    convert.load_state(pt, convert.jax_trainer_state(jt))
    writer, reader = (jt, pt) if direction == "jax_to_port" else (pt, jt)
    before = convert.export_state(pt) if reader is pt else \
        convert.jax_trainer_state(jt)
    for i, p in enumerate(more):
        writer.train_step(*p, ts=500 + i)
    save, load = ((jckpt.save_delta, pckpt.restore_delta)
                  if direction == "jax_to_port"
                  else (pckpt.save_delta, jckpt.restore_delta))
    path = save(writer, str(tmp_path), since_ts=500, base_step=3)
    z = np.load(os.path.join(path, "sparse-s0.npz"))
    assert sorted(z.files) == ["counts", "fids", "tss", "values"]
    assert z["values"].dtype == np.float32 and z["fids"].dtype == np.int64
    assert (z["tss"] >= 500).all()
    touched = z["fids"]
    old_fids = before["stores"]["sparse"][0]
    assert 0 < len(np.intersect1d(touched, old_fids)) < len(touched)
    applied = load(reader, path)
    assert applied == len(touched)
    assert int(reader.step) == int(writer.step) == 5
    np.testing.assert_array_equal(_params_of(reader, touched),
                                  _params_of(writer, touched))
    np.testing.assert_array_equal(_params_of(writer, touched), z["values"])
    # ids the delta did not carry keep the base state's rows, slots too
    after = convert.export_state(pt) if reader is pt else \
        convert.jax_trainer_state(jt)
    untouched = np.setdiff1d(old_fids, touched)
    assert len(untouched) > 0
    f, r = before["stores"]["sparse"][:2]
    rows = r[np.isin(f, untouched)]
    np.testing.assert_array_equal(after["tables"]["sparse"][0][rows],
                                  before["tables"]["sparse"][0][rows])
    # a touched old id keeps its optimizer slots; a new id has fresh ones
    f2, r2 = after["stores"]["sparse"][:2]
    new_rows = r2[np.isin(f2, np.setdiff1d(touched, old_fids))]
    np.testing.assert_array_equal(
        after["tables"]["sparse"][0][new_rows][:, 9:17],
        np.full((len(new_rows), 8),
                np.float32(torch.tensor(0.01).to(pdt).float().item())))
    old_rows = r[np.isin(f, touched)]
    np.testing.assert_array_equal(
        after["tables"]["sparse"][0][old_rows][:, 9:],
        before["tables"]["sparse"][0][old_rows][:, 9:])


def test_delta_drops_ids_the_store_refuses(tmp_path):
    """A reader whose table is full maps the delta's new ids to row -1:
    they drop and are not counted."""
    pairs = batches(2, seed=71)
    a = port_trainer()
    for i, p in enumerate(pairs):
        a.train_step(*p, ts=100 + i)
    path = pckpt.save_delta(a, str(tmp_path), since_ts=0)
    n = a.engine.stores["sparse"].size()
    b = port_trainer(capacity_per_shard=n - 10)
    applied = pckpt.restore_delta(b, path)
    assert applied == n - 10 == b.engine.stores["sparse"].size()
    fids = np.load(os.path.join(path, "sparse-s0.npz"))["fids"]
    rows = b.engine.stores["sparse"].lookup(fids)
    kept = fids[rows >= 0]
    np.testing.assert_array_equal(_params_of(b, kept), _params_of(a, kept))


def test_empty_delta(tmp_path):
    a = port_trainer()
    a.train_step(*batches(1)[0], ts=100)
    path = pckpt.save_delta(a, str(tmp_path), since_ts=10 ** 9)
    z = np.load(os.path.join(path, "sparse-s0.npz"))
    assert z["values"].shape == (0, 9) and len(z["fids"]) == 0
    b = port_trainer()
    assert pckpt.restore_delta(b, path) == 0 and b.step == 1


# ----------------------------------------------------------------------
# (f) dense-only checkpoints; (g) what is not ported raises
# ----------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["port_to_port", "jax_to_port",
                                       "port_to_jax"])
def test_dense_only_checkpoint(tmp_path, direction, jax_to_port):
    pairs = jax_to_port[4]
    if direction.startswith("port"):
        writer = port_trainer()
        for i, p in enumerate(pairs[:3]):
            writer.train_step(*p, ts=100 + i)
        path = pckpt.save(writer, str(tmp_path), dense_only=True)
        want = convert.export_state(writer)
    else:
        writer = jax_to_port[0]
        path = jckpt.save(writer, str(tmp_path), dense_only=True)
        want = convert.jax_trainer_state(writer)
    assert _listing(path) == ["dense.msgpack", "meta.json",
                              "opt_state.msgpack"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["dense_only"] is True and meta["tables"] == {}
    if direction.endswith("port"):
        reader = port_trainer(seed=5)
        fresh = convert.export_state(reader)
        pckpt.restore(reader, str(tmp_path))
        got = convert.export_state(reader)
    else:
        reader = jax_ready(jax_trainer(seed=5), pairs[0])
        fresh = convert.jax_trainer_state(reader)
        jckpt.restore(reader, str(tmp_path))
        got = convert.jax_trainer_state(reader)
    assert got["step"] == want["step"]
    for tree in ("params", "opt_state"):
        x, y = (convert._to_module_tensors(s[tree]) for s in (got, want))
        for name in y:
            np.testing.assert_array_equal(x[name], y[name])
    # tables and stores are as they were before the restore
    np.testing.assert_array_equal(got["tables"]["sparse"],
                                  fresh["tables"]["sparse"])
    assert len(got["stores"]["sparse"][0]) == len(fresh["stores"]["sparse"][0])


def test_evict_before_save_is_not_ported(tmp_path):
    """save(evict_before_save=True) runs expiry first (now - ttl) in both
    packages: the ids last updated before it leave the store, their rows
    read zero, and the checkpoint written by either package holds the
    same store and pool."""
    now = int(time.time())
    pairs = batches(2, seed=83)
    states = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            tr = jax_ready(jax_trainer(ttl_seconds=100, init_scale=0.0),
                           pairs[0])
            tr.engine.stores["sparse"][0].restore(np.empty(0, np.int64),
                                                  np.empty(0, np.int32))
            port = port_trainer(ttl_seconds=100, init_scale=0.0)
            convert.load_state(port, convert.jax_trainer_state(tr))
        else:
            tr = port
        tr.train_step(*pairs[0], ts=now - 1000)
        tr.train_step(*pairs[1], ts=now)
        path = (jckpt if pkg == "jax" else pckpt).save(
            tr, str(tmp_path / pkg), evict_before_save=True)
        z = np.load(os.path.join(path, "tables", "sparse-s0.npz"))
        states[pkg] = {k: z[k] for k in ("fids", "rows", "tss", "pool")}
    a, b = states["jax"], states["port"]
    for k in ("fids", "rows", "tss"):
        np.testing.assert_array_equal(b[k], a[k])
    np.testing.assert_allclose(b["pool"], a["pool"], atol=1e-5)
    assert (b["tss"] == now).all()
    live = set(np.concatenate([v.ravel() for v in pairs[1][0].values()]
                              ).tolist()) - {-1}
    assert set(b["fids"].tolist()) == live


def test_restore_picks_the_step_asked_for(tmp_path):
    a = port_trainer()
    pairs = batches(3, seed=81)
    a.train_step(*pairs[0], ts=1)
    pckpt.save(a, str(tmp_path))
    first = convert.export_state(a)
    a.train_step(*pairs[1], ts=2)
    pckpt.save(a, str(tmp_path))
    assert pckpt.latest_step(str(tmp_path)) == 2
    b = port_trainer(seed=6)
    assert pckpt.restore(b, str(tmp_path), step=1) == 1
    assert_states_equal(convert.export_state(b), first)
    assert pckpt.restore(b, str(tmp_path)) == 2
    assert_states_equal(convert.export_state(b), convert.export_state(a))
