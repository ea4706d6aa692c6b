"""The port's way out of the trainer, on the CPU: export, `ServingModel`,
the streaming push of touched rows, hot swaps; and exports crossing the two
packages.

Sizes are tests/test_serving.py's: DeepFMTask(embedding_dim=8,
capacity_per_shard=4096, hidden=(16, 8)), unique_cap 512, batch 128, 80
users x 40 items; inputs made from a seed with numpy; the port serves with
device="cpu". Tolerances: a serving replica against the trainer's eval
predictions rtol 1e-4 / atol 1e-5 (the JAX test's bar); the two packages'
ServingModels on one export rtol 1e-5 / atol 1e-6 (f32 sums in another
order); export files of one carried state, pushed rows and row lookups
exact.
"""

import dataclasses
import os
import threading
import types

import numpy as np
import pytest
import torch

from monolith_tpu.embedding import compressors as jcomp
from monolith_tpu.embedding import retrievers as jret
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.serving import ServingModel as JaxServingModel
from monolith_tpu.serving import export_model as jax_export_model
from monolith_tpu.serving.export import read_warmup_data as jax_read_warmup
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert, serialization
from monolith_tpu_torch.data.synthetic import SyntheticCTR, SyntheticMultiSlot
from monolith_tpu_torch.embedding import compressors as pcomp
from monolith_tpu_torch.embedding import retrievers as pret
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.embedding.host_store import shard_of, shard_of_batch
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.models.multislot import MultiSlotTask
from monolith_tpu_torch.serving import (ServingModel, codec, export_model,
                                        latest_export)
from monolith_tpu_torch.serving.export import (read_warmup_data,
                                               write_warmup_data)
from monolith_tpu_torch.training import streaming as streaming_mod
from monolith_tpu_torch.training import trainer as trainer_mod
from monolith_tpu_torch.training.streaming import (StreamingConfig,
                                                   StreamingTrainer)
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

TASK = dict(embedding_dim=8, capacity_per_shard=4096, hidden=(16, 8))


def make_task(**kw):
    return DeepFMTask(**{**TASK, **kw})


def make_trainer(record_touch=False, seed=51, task=None):
    cfg = TrainerConfig(engine=EngineConfig(unique_cap=512, new_cap=512,
                                            record_touch=record_touch),
                        log_every=0, seed=seed)
    return Trainer(task or make_task(), cfg, device="cpu")


def train_some(trainer, steps=30, seed=51, batch_size=128):
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=batch_size,
                        seed=seed)
    for _ in range(steps):
        trainer.train_step(*data.batch())
    return data


def serve(path, task=None, **kw):
    return ServingModel(task or make_task(), path, device="cpu", **kw)


class PushTo:
    """The stand-in for a parameter-sync client: a push lands in one
    ServingModel's apply_delta, which is all a serving agent does with it."""

    def __init__(self, model):
        self.model, self.pushes = model, []

    def push(self, table, fids, values):
        self.pushes.append((table, fids.copy(), values.copy()))
        return {"local": self.model.apply_delta(table, fids, values)}


# ----------------------------------------------------------------------
# export and serve
# ----------------------------------------------------------------------

class TestExportServe:
    def test_export_and_predict_parity(self, tmp_path):
        trainer = make_trainer()
        data = train_some(trainer)
        path = export_model(trainer, str(tmp_path))
        model = serve(path)
        fb, b = data.batch()
        serving_preds = model.predict(fb, b)
        assert serving_preds.shape == (128,)
        assert serving_preds.dtype == np.float32
        np.testing.assert_allclose(serving_preds,
                                   trainer.predict(fb, b).numpy(),
                                   rtol=1e-4, atol=1e-5)

    def test_export_layout(self, tmp_path):
        trainer = make_trainer()
        train_some(trainer, steps=3)
        path = export_model(trainer, str(tmp_path))
        assert path == os.path.join(str(tmp_path), "export-3")
        assert latest_export(str(tmp_path)) == path
        assert latest_export(str(tmp_path / "nothing")) is None
        assert sorted(os.listdir(path)) == ["dense.msgpack", "meta.json",
                                            "tables"]
        z = np.load(os.path.join(path, "tables", "sparse-s0.npz"))
        assert sorted(z.files) == ["fids", "seg0:data", "seg1:data"]
        n = trainer.engine.stores["sparse"].size()
        assert z["seg0:data"].shape == (n, 1) and z["seg1:data"].shape == (n, 8)
        model = serve(path)
        assert model.meta["tables"]["sparse"] == {
            "shards": 1, "dim": 9, "capacity_per_shard": 4096,
            "segments": [{"dim": 1, "compressor": "fp32"},
                         {"dim": 8, "compressor": "fp32"}]}
        assert model.table_sizes() == {"sparse": n} and model.step == 3
        assert model.capacity["sparse"] == int(n * 1.25) + 1024
        assert tuple(model.pools["sparse"].shape) == (model.capacity["sparse"], 9)
        assert model.pools["sparse"].dtype == torch.float32
        # an explicit step names the export
        assert export_model(trainer, str(tmp_path), step=77).endswith(
            "export-77")
        assert latest_export(str(tmp_path)).endswith("export-77")

    def test_missing_ids_predict_cold(self, tmp_path):
        trainer = make_trainer()
        train_some(trainer, steps=5)
        model = serve(export_model(trainer, str(tmp_path)))
        fb = {"user_id": np.array([[999_999_999]], np.int64),
              "item_id": np.array([[888_888_888]], np.int64),
              "hist_items": np.full((1, 10), -1, np.int64)}
        preds = model.predict(fb, {"label": np.zeros(1, np.float32)})
        assert preds.shape == (1,) and np.isfinite(preds).all()
        # no batch at all is fine too
        np.testing.assert_array_equal(model.predict(fb), preds)

    def test_lookup_rows_reads_values_and_zeros_for_unknown_ids(self, tmp_path):
        trainer = make_trainer()
        train_some(trainer, steps=5)
        model = serve(export_model(trainer, str(tmp_path)))
        fids, rows, _, _ = trainer.engine.stores["sparse"].save()
        pool = ptable.params_np(trainer.engine.tables["sparse"],
                                trainer.table_states["sparse"])
        ask = np.concatenate([fids[:7], [123, 456], fids[7:9]])
        got = model.lookup_rows("sparse", ask)
        assert got.shape == (11, 9) and got.dtype == np.float32
        np.testing.assert_array_equal(got[:7], pool[rows[:7]])
        np.testing.assert_array_equal(got[7:9], 0.0)
        np.testing.assert_array_equal(got[9:], pool[rows[7:9]])

    def test_apply_delta_changes_prediction(self, tmp_path):
        trainer = make_trainer()
        data = train_some(trainer, steps=10)
        model = serve(export_model(trainer, str(tmp_path)))
        fb, b = data.batch()
        before = model.predict(fb, b)
        uid = np.unique(fb["user_id"].ravel())
        applied = model.apply_delta("sparse", uid,
                                    np.full((len(uid), 9), 5.0, np.float32))
        assert applied == len(uid)
        assert not np.allclose(before, model.predict(fb, b))
        np.testing.assert_array_equal(model.lookup_rows("sparse", uid), 5.0)
        with pytest.raises(ValueError, match=r"not \[n, 9\]"):
            model.apply_delta("sparse", uid, np.zeros((len(uid), 8), np.float32))

    def test_apply_delta_drops_ids_beyond_capacity(self, tmp_path):
        trainer = make_trainer()
        train_some(trainer, steps=2)
        model = serve(export_model(trainer, str(tmp_path)), headroom=0.0)
        free = model.capacity["sparse"] - model.table_sizes()["sparse"]
        assert free == 1024
        fids = np.arange(10_000, 10_000 + free + 5, dtype=np.int64)
        vals = np.arange(len(fids), dtype=np.float32)[:, None].repeat(9, 1) + 1
        assert model.apply_delta("sparse", fids, vals) == free
        got = model.lookup_rows("sparse", fids)
        kept = model.stores["sparse"].lookup(fids) >= 0
        assert kept.sum() == free
        np.testing.assert_array_equal(got[kept], vals[kept])
        np.testing.assert_array_equal(got[~kept], 0.0)

    def test_bf16_pool_exports_as_f32(self, tmp_path):
        trainer = make_trainer(task=make_task(table_dtype=torch.bfloat16,
                                              stochastic_rounding=True))
        data = train_some(trainer, steps=10)
        path = export_model(trainer, str(tmp_path))
        z = np.load(os.path.join(path, "tables", "sparse-s0.npz"))
        assert z["seg1:data"].dtype == np.float32
        model = serve(path, task=make_task(table_dtype=torch.bfloat16,
                                           stochastic_rounding=True))
        assert model.pools["sparse"].dtype == torch.float32
        fb, b = data.batch()
        np.testing.assert_allclose(model.predict(fb, b),
                                   trainer.predict(fb, b).numpy(),
                                   rtol=1e-4, atol=1e-5)

    def test_default_device_is_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        trainer = make_trainer()
        train_some(trainer, steps=1)
        path = export_model(trainer, str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingModel(make_task(), path)

    def test_a_wrong_dense_file_does_not_load(self, tmp_path):
        trainer = make_trainer()
        train_some(trainer, steps=1)
        path = export_model(trainer, str(tmp_path))
        with pytest.raises(ValueError, match="keys differ"):
            serve(path, task=make_task(hidden=(16,)))
        with pytest.raises(ValueError, match="shape"):
            serve(path, task=make_task(hidden=(32, 8)))

    def test_warmup_data_round_trip_in_both_packages(self, tmp_path):
        trainer = make_trainer()
        data = train_some(trainer, steps=2)
        path = export_model(trainer, str(tmp_path))
        pairs = [data.batch() for _ in range(3)]
        out = write_warmup_data(path, [p[0] for p in pairs],
                                [p[1] for p in pairs])
        assert out == os.path.join(path, "warmup.rec")
        model = serve(path)
        for read in (read_warmup_data, jax_read_warmup):
            got = list(read(path))
            assert len(got) == 3
            for (fb, b), (gfb, gb) in zip(pairs, got):
                assert sorted(gfb) == sorted(fb) and sorted(gb) == sorted(b)
                for k in fb:
                    np.testing.assert_array_equal(gfb[k], fb[k])
                for k in b:
                    np.testing.assert_array_equal(gb[k], b[k])
                    assert gb[k].dtype == b[k].dtype
        gfb, gb = next(iter(read_warmup_data(path)))
        np.testing.assert_array_equal(model.predict(gfb, gb),
                                      model.predict(*pairs[0]))
        assert codec.unpack(codec.pack({"x": 1}))["x"] == 1


# ----------------------------------------------------------------------
# realtime: the streaming push
# ----------------------------------------------------------------------

class TestRealtime:
    def test_streaming_sync_converges_serving_to_trainer(self, tmp_path):
        trainer = make_trainer(record_touch=True)
        data = train_some(trainer, steps=5, seed=52)
        model = serve(export_model(trainer, str(tmp_path)))
        st = StreamingTrainer(trainer, PushTo(model),
                              StreamingConfig(sync_interval_steps=10))

        def stream():
            for _ in range(40):
                yield data.batch()

        res = st.run(stream())
        assert res["steps"] == 40
        assert res["pushed_rows"] > 0 and res["sync_rounds"] >= 4
        assert np.isfinite(res["loss"]) and 0 <= res["auc"] <= 1
        fb, b = data.batch()
        # dense params differ (serving has the export-time tower), but the
        # sparse rows are synced: correlation must be high
        corr = np.corrcoef(model.predict(fb, b),
                           trainer.predict(fb, b).numpy())[0, 1]
        assert corr > 0.8, f"serving does not track trainer: corr={corr}"

    def test_every_pushed_row_equals_the_trainers(self, tmp_path):
        trainer = make_trainer(record_touch=True)
        data = train_some(trainer, steps=5, seed=53)
        model = serve(export_model(trainer, str(tmp_path)))
        sync = PushTo(model)
        st = StreamingTrainer(trainer, sync,
                              StreamingConfig(sync_interval_steps=10))
        res = st.run(iter(data), max_steps=40)
        assert res["steps"] == 40 and res["sync_rounds"] == 5  # 4 + flush
        pushed = np.unique(np.concatenate([f for _, f, _ in sync.pushes]))
        assert res["pushed_rows"] == sum(len(f) for _, f, _ in sync.pushes)
        assert len(pushed) > 100
        rows = trainer.engine.stores["sparse"].lookup(pushed)
        assert (rows >= 0).all()
        want = ptable.params_np(trainer.engine.tables["sparse"],
                                trainer.table_states["sparse"])[rows]
        np.testing.assert_array_equal(model.lookup_rows("sparse", pushed),
                                      want)
        # everything was drained; ids the 5 steps before the export touched
        # were drained by the first round too
        assert trainer.engine.stores["sparse"].touched_size() == 0
        assert st.sync_now() == {} and st.sync_rounds == 6

    def test_predicts_during_pushes_see_whole_pushes(self, tmp_path):
        """Threads predict and look rows up while apply_delta pushes: push
        k sets every row of the batch's ids to 0.01 * k, so a row lookup
        must read ONE value over all rows and columns, and a prediction
        must be that of one k (rtol 1e-6): never a part of a push."""
        trainer = make_trainer()
        data = train_some(trainer, steps=10)
        path = export_model(trainer, str(tmp_path))
        fb, b = data.batch()
        fids = np.unique(np.concatenate([v.ravel() for v in fb.values()]))
        fids = fids[fids >= 0]
        dim = make_task().tables()[0].dim
        pushes = 20

        def values(k):
            return np.full((len(fids), dim), 0.01 * k, np.float32)

        want = []
        ref = serve(path)
        for k in range(pushes + 1):
            ref.apply_delta("sparse", fids, values(k))
            want.append(ref.predict(fb, b))
        assert not np.allclose(want[0], want[pushes])
        model = serve(path)
        model.apply_delta("sparse", fids, values(0))
        stop, bad, count = threading.Event(), [], [0]

        def reader():
            while not stop.is_set():
                rows = model.lookup_rows("sparse", fids)
                got = model.predict(fb, b)
                count[0] += 1
                if rows.min() != rows.max():
                    bad.append(("rows", rows.min(), rows.max()))
                if not any(np.allclose(got, w, rtol=1e-6, atol=1e-7)
                           for w in want):
                    bad.append(("predict", got))

        threads = [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for k in range(1, pushes + 1):
            assert model.apply_delta("sparse", fids, values(k)) == len(fids)
        stop.set()
        for t in threads:
            t.join()
        assert count[0] > 0 and not bad, bad[:3]
        np.testing.assert_array_equal(model.lookup_rows("sparse", fids),
                                      values(pushes))

    def test_pad_cap_is_a_power_of_two_from_512(self):
        assert [StreamingTrainer._pad_cap(n) for n in
                (0, 1, 512, 513, 1024, 1025, 5000)] == [
                    512, 512, 512, 1024, 1024, 2048, 8192]

    def test_record_touch_is_required_and_eviction_is_not_ported(
            self, monkeypatch):
        """record_touch is required for a sync target. Periodic expiry
        runs (evict_interval_steps): with the clock moved past the ttl, the
        loop's eviction frees every id not trained since, and zeroes its
        row."""
        with pytest.raises(ValueError, match="record_touch"):
            StreamingTrainer(make_trainer(), PushTo(None))
        StreamingTrainer(make_trainer(), None)        # no sync: allowed
        now = [0]
        for mod in (streaming_mod, trainer_mod):
            monkeypatch.setattr(mod, "time",
                                types.SimpleNamespace(time=lambda: now[0]))
        trainer = make_trainer(task=make_task(ttl_seconds=60))
        data = SyntheticCTR(num_users=80, num_items=40, batch_size=128,
                            seed=55)
        pairs = [data.batch() for _ in range(3)]

        def stream():
            for i, pair in enumerate(pairs):
                now[0] = 0 if i < 2 else 200
                yield pair

        freed = []
        evict = trainer.evict_expired
        trainer.evict_expired = lambda ts: freed.append(evict(ts)) or freed[-1]
        st = StreamingTrainer(trainer, None,
                              StreamingConfig(evict_interval_steps=3))
        assert st.run(stream())["steps"] == 3
        last = np.concatenate([v.ravel() for v in pairs[2][0].values()])
        fids = trainer.engine.stores["sparse"].save()[0]
        assert set(fids.tolist()) == set(last[last >= 0].tolist())
        rows = freed[0]["sparse"]
        assert len(rows) > 0
        assert not trainer.table_states["sparse"]["data"][
            torch.from_numpy(rows)].any()

    def test_without_a_sync_target_nothing_is_drained(self):
        trainer = make_trainer(record_touch=True)
        st = StreamingTrainer(trainer, None)
        data = SyntheticCTR(num_users=80, num_items=40, batch_size=128,
                            seed=54)
        res = st.run(iter(data), max_steps=3)
        assert res["pushed_rows"] == 0 and res["sync_rounds"] == 0
        assert trainer.engine.stores["sparse"].touched_size() > 0
        assert st.sync_now() == {}

    def test_streaming_pushes_the_retrieved_view(self, tmp_path):
        """A FakeQuant segment is pushed as training's forward saw it."""
        fq = pret.FakeQuant(r=0.25)

        class QuantTask(DeepFMTask):
            def tables(self):
                t = super().tables()[0]
                vec = dataclasses.replace(t.segments[1], retriever=fq)
                return [dataclasses.replace(t, segments=(t.segments[0], vec))]

        trainer = make_trainer(record_touch=True, task=QuantTask(**TASK))
        data = train_some(trainer, steps=3, seed=55)
        model = serve(export_model(trainer, str(tmp_path)),
                      task=QuantTask(**TASK))
        sync = PushTo(model)
        StreamingTrainer(trainer, sync, StreamingConfig(
            sync_interval_steps=4)).run(iter(data), max_steps=4)
        _, fids, vals = sync.pushes[-1]
        rows = trainer.engine.stores["sparse"].lookup(fids)
        raw = ptable.params_np(trainer.engine.tables["sparse"],
                               trainer.table_states["sparse"])[rows]
        np.testing.assert_array_equal(vals[:, :1], raw[:, :1])
        np.testing.assert_array_equal(vals[:, 1:], fq.retrieve(raw[:, 1:], 0))
        assert not np.array_equal(vals[:, 1:], raw[:, 1:])
        # and the export baked the same view in
        np.testing.assert_array_equal(model.lookup_rows("sparse", fids), vals)

    def test_streaming_writes_dense_and_full_checkpoints(self, tmp_path):
        from monolith_tpu_torch.training import checkpoint
        trainer = make_trainer(record_touch=True)
        st = StreamingTrainer(trainer, None, StreamingConfig(
            dense_ckpt_interval_steps=2, full_ckpt_interval_steps=3,
            ckpt_dir=str(tmp_path)))
        data = SyntheticCTR(num_users=80, num_items=40, batch_size=128,
                            seed=56)
        st.run(iter(data), max_steps=4)
        assert sorted(os.listdir(str(tmp_path))) == [
            "CHECKPOINT", "ckpt-2", "ckpt-3", "ckpt-4"]
        assert not os.listdir(str(tmp_path / "ckpt-4" / "tables"))
        assert os.listdir(str(tmp_path / "ckpt-3" / "tables")) == [
            "sparse-s0.npz"]
        assert checkpoint.latest_step(str(tmp_path)) == 4

    def test_dense_reload(self, tmp_path):
        trainer = make_trainer()
        data = train_some(trainer, steps=5)
        model = serve(export_model(trainer, str(tmp_path)))
        fb, b = data.batch()
        before = model.predict(fb, b)
        train_some(trainer, steps=20)  # the dense tower moves
        model.reload_dense(serialization.to_bytes(
            convert.dense_tree(trainer.module.named_parameters())))
        after = model.predict(fb, b)
        assert not np.allclose(before, after)
        for (n, p), (_, q) in zip(model.module.named_parameters(),
                                  trainer.module.named_parameters()):
            assert torch.equal(p, q), n
        with pytest.raises(ValueError, match="keys differ"):
            model.reload_dense(serialization.to_bytes({"deep": {}}))


# ----------------------------------------------------------------------
# row-sharded serving (the filter at load; the router is not ported)
# ----------------------------------------------------------------------

class TestShardedServing:
    def test_row_shards_partition_the_export(self, tmp_path):
        trainer = make_trainer()
        train_some(trainer, steps=20)
        path = export_model(trainer, str(tmp_path))
        single = serve(path)
        shards = [serve(path, shard_index=s, num_row_shards=2)
                  for s in range(2)]
        sizes = [m.table_sizes()["sparse"] for m in shards]
        assert sum(sizes) == single.table_sizes()["sparse"]
        assert all(n > 0 for n in sizes)
        fids = trainer.engine.stores["sparse"].save()[0]
        owner = shard_of_batch(fids, 2)
        assert [shard_of(int(f), 2) for f in fids[:50]] == owner[:50].tolist()
        whole = single.lookup_rows("sparse", fids)
        for s, m in enumerate(shards):
            got = m.lookup_rows("sparse", fids)
            np.testing.assert_array_equal(got[owner == s], whole[owner == s])
            np.testing.assert_array_equal(got[owner != s], 0.0)
        # the shards' rows add up to the single replica's
        np.testing.assert_array_equal(
            sum(m.lookup_rows("sparse", fids) for m in shards), whole)


# ----------------------------------------------------------------------
# version hot swap
# ----------------------------------------------------------------------

class TestVersionHotSwap:
    def test_reload_export_swaps_to_new_version(self, tmp_path):
        trainer = make_trainer()
        data = train_some(trainer, steps=20)
        base = str(tmp_path)
        path_a = export_model(trainer, base)
        model = serve(path_a)
        assert latest_export(base) == path_a
        fb, b = next(iter(data))
        preds_a = model.predict(fb, b)

        train_some(trainer, steps=25, seed=52)
        path_b = export_model(trainer, base)
        assert path_b != path_a and latest_export(base) == path_b
        assert model.reload_export(path_b) == 45 == model.step

        preds_b = model.predict(fb, b)
        np.testing.assert_allclose(preds_b, serve(path_b).predict(fb, b),
                                   rtol=1e-6, atol=1e-6)
        assert not np.allclose(preds_a, preds_b)  # really a new version

        # delta pushes still apply after the swap
        applied = model.apply_delta("sparse", np.array([999999], np.int64),
                                    np.ones((1, 9), np.float32))
        assert applied == 1
        np.testing.assert_array_equal(
            model.lookup_rows("sparse", np.array([999999], np.int64)),
            np.ones((1, 9), np.float32))

    def test_predicts_in_flight_see_one_version_or_the_other(self, tmp_path):
        """Threads predict while the model swaps between two exports: every
        answer is version A's or version B's, never a pairing of one
        version's row indices with the other's pools or tower."""
        trainer = make_trainer()
        data = train_some(trainer, steps=10)
        path_a = export_model(trainer, str(tmp_path))
        fb, b = data.batch()
        # version B has other rows AND another id -> row map: its ids were
        # admitted in another order
        other = make_trainer(seed=7)
        train_some(other, steps=30, seed=99)
        other.train_step(fb, b)
        path_b = export_model(other, str(tmp_path))
        model = serve(path_a)
        want = {p: serve(p).predict(fb, b) for p in (path_a, path_b)}
        assert not np.allclose(want[path_a], want[path_b])
        stop, bad, count = threading.Event(), [], [0]

        def predictor():
            while not stop.is_set():
                got = model.predict(fb, b)
                count[0] += 1
                if not any(np.allclose(got, w, rtol=1e-6, atol=1e-6)
                           for w in want.values()):
                    bad.append(got)

        threads = [threading.Thread(target=predictor) for _ in range(3)]
        for t in threads:
            t.start()
        for i in range(6):
            model.reload_export(path_b if i % 2 == 0 else path_a)
        stop.set()
        for t in threads:
            t.join()
        assert count[0] > 0 and not bad


# ----------------------------------------------------------------------
# merged and binned tables
# ----------------------------------------------------------------------

class TestBinnedMergeServing:
    def test_binned_merge_export_serving_roundtrip(self, tmp_path):
        """A model trained with merge_max_bytes binning must export and
        serve identically to the single-pool merged model: binning must be
        invisible end to end, not just in training losses."""
        preds = {}
        for cap_bytes in (0, 3 * 8192 * 512):  # 0 = one pool; else ~2 bins
            task = MultiSlotTask(num_tables=4, num_slots=10, embedding_dim=8,
                                 capacity_per_shard=8192, history_length=6,
                                 hidden=(32,), init_scale=0.0, merge=True,
                                 merge_max_bytes=cap_bytes)
            if cap_bytes:
                assert len(task.tables()) > 1
            tr = Trainer(task, TrainerConfig(
                engine=EngineConfig(unique_cap=4096, new_cap=4096),
                log_every=0), device="cpu")
            data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                                      history_length=6, batch_size=256,
                                      seed=3)
            for _ in range(10):
                tr.train_step(*data.batch())
            path = export_model(tr, str(tmp_path / f"bin{cap_bytes}"))
            model = ServingModel(task, path, device="cpu")
            fb, b = data.batch()  # a batch with ids both seen and unseen
            preds[cap_bytes] = model.predict(fb, b)
            np.testing.assert_allclose(preds[cap_bytes],
                                       tr.predict(fb, b).numpy(),
                                       rtol=1e-4, atol=1e-5)
        vals = list(preds.values())
        assert np.isfinite(vals[0]).all()
        np.testing.assert_array_equal(vals[0], vals[1])


# ----------------------------------------------------------------------
# exports cross the packages
# ----------------------------------------------------------------------

def _variant(package, kind):
    """A DeepFM task of either package whose segments carry `kind`'s
    serving compressors or retriever."""
    base, comp, ret = ((JaxDeepFMTask, jcomp, jret) if package == "jax"
                       else (DeepFMTask, pcomp, pret))
    changes = {
        "plain": ({}, {}),
        "fp16_fixed_r8": ({"compressor": comp.Fp16()},
                          {"compressor": comp.FixedR8()}),
        "one_bit": ({}, {"compressor": comp.OneBit()}),
        "fake_quant_fp16": ({}, {"retriever": ret.FakeQuant(r=0.25),
                                 "compressor": comp.Fp16()}),
        "hash_net": ({}, {"retriever": ret.HashNet(amplitude=0.5)}),
    }[kind]

    class Variant(base):
        def tables(self):
            t = super().tables()[0]
            segs = tuple(dataclasses.replace(s, **c)
                         for s, c in zip(t.segments, changes))
            return [dataclasses.replace(t, segments=segs)]
    return Variant(**TASK)


KINDS = ["plain", "fp16_fixed_r8", "one_bit", "fake_quant_fp16", "hash_net"]


def _jax_trainer(task):
    return JaxTrainer(task, JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=512, new_cap=512),
        log_every=0, seed=51))


@pytest.mark.parametrize("kind", KINDS)
def test_jax_export_serves_in_the_port(tmp_path, kind):
    jt = _jax_trainer(_variant("jax", kind))
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=128, seed=51)
    for _ in range(12):
        jt.train_step(*data.batch())
    path = jax_export_model(jt, str(tmp_path))
    jmodel = JaxServingModel(_variant("jax", kind), path, unique_cap=512)
    pmodel = serve(path, task=_variant("port", kind), unique_cap=512)
    assert pmodel.table_sizes() == jmodel.table_sizes()
    for _ in range(2):
        fb, b = data.batch()
        np.testing.assert_allclose(pmodel.predict(fb, b),
                                   jmodel.predict(fb, b),
                                   rtol=1e-5, atol=1e-6)
    fids = jt.engine.stores["sparse"][0].save()[0]
    np.testing.assert_array_equal(pmodel.lookup_rows("sparse", fids),
                                  jmodel.lookup_rows("sparse", fids))


@pytest.mark.parametrize("kind", KINDS)
def test_port_export_serves_in_jax(tmp_path, kind):
    pt = make_trainer(task=_variant("port", kind))
    data = train_some(pt, steps=12)
    path = export_model(pt, str(tmp_path))
    jmodel = JaxServingModel(_variant("jax", kind), path, unique_cap=512)
    pmodel = serve(path, task=_variant("port", kind), unique_cap=512)
    assert jmodel.table_sizes() == pmodel.table_sizes()
    assert jmodel.step == pmodel.step == 12
    for _ in range(2):
        fb, b = data.batch()
        np.testing.assert_allclose(jmodel.predict(fb, b),
                                   pmodel.predict(fb, b),
                                   rtol=1e-5, atol=1e-6)
    fids = pt.engine.stores["sparse"].save()[0]
    np.testing.assert_array_equal(jmodel.lookup_rows("sparse", fids),
                                  pmodel.lookup_rows("sparse", fids))


@pytest.mark.parametrize("kind", KINDS)
def test_exports_of_one_carried_state_hold_the_same_arrays(tmp_path, kind):
    """The JAX trainer's state carried into the port by convert.py: both
    packages' exports then hold, fid by fid, the same compressed arrays
    (FakeQuant and the compressors exactly; HashNet's tanh to 1e-6), and
    the same dense bytes."""
    jt = _jax_trainer(_variant("jax", kind))
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=128, seed=57)
    for _ in range(6):
        jt.train_step(*data.batch())
    pt = Trainer(_variant("port", kind), convert.port_trainer_config(
        jt.config), device="cpu")
    convert.load_state(pt, convert.jax_trainer_state(jt))
    jpath = jax_export_model(jt, str(tmp_path / "jax"))
    ppath = export_model(pt, str(tmp_path / "port"))
    with open(os.path.join(jpath, "dense.msgpack"), "rb") as f, \
            open(os.path.join(ppath, "dense.msgpack"), "rb") as g:
        assert f.read() == g.read()
    jz = np.load(os.path.join(jpath, "tables", "sparse-s0.npz"))
    pz = np.load(os.path.join(ppath, "tables", "sparse-s0.npz"))
    assert sorted(pz.files) == sorted(jz.files)
    jo, po = np.argsort(jz["fids"]), np.argsort(pz["fids"])
    np.testing.assert_array_equal(pz["fids"][po], jz["fids"][jo])
    for k in jz.files:
        assert pz[k].dtype == jz[k].dtype, k
        a, b = (pz[k], jz[k]) if pz[k].ndim == 0 else (pz[k][po], jz[k][jo])
        if kind == "hash_net" and k == "seg1:data":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    import json
    jm, pm = (json.load(open(os.path.join(p, "meta.json")))
              for p in (jpath, ppath))
    assert pm["tables"] == jm["tables"] and pm["step"] == jm["step"] == 6


def test_sharded_jax_export_merges_at_load(tmp_path):
    """A sharded JAX trainer writes one -s<k>.npz a shard; the port's
    ServingModel merges them into one store and pool, as JAX's does."""
    from monolith_tpu.parallel import ShardedTrainer, make_mesh
    tr = ShardedTrainer(
        JaxDeepFMTask(**{**TASK, "capacity_per_shard": 2048}),
        JaxTrainerConfig(engine=JaxEngineConfig(num_shards=2, unique_cap=512,
                                                new_cap=512), log_every=0),
        make_mesh(2))
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=128, seed=58)
    for _ in range(6):
        tr.train_step(*data.batch())
    path = jax_export_model(tr, str(tmp_path))
    assert sorted(os.listdir(os.path.join(path, "tables"))) == [
        "sparse-s0.npz", "sparse-s1.npz"]
    jmodel = JaxServingModel(JaxDeepFMTask(**TASK), path, unique_cap=512)
    pmodel = serve(path, unique_cap=512)
    assert pmodel.table_sizes() == jmodel.table_sizes()
    assert pmodel.table_sizes()["sparse"] == sum(
        s.size() for s in tr.engine.stores["sparse"])
    fb, b = data.batch()
    np.testing.assert_allclose(pmodel.predict(fb, b), jmodel.predict(fb, b),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["plain", "fake_quant_fp16"])
def test_serving_logits_equal_jax(tmp_path, kind):
    """ServingModel._forward returns (predictions, logits) in both
    packages: on one export, the port's logits equal the JAX ServingModel's
    (rtol 1e-5), and predict returns the predictions."""
    pt = make_trainer(task=_variant("port", kind))
    data = train_some(pt, steps=8)
    path = export_model(pt, str(tmp_path))
    jmodel = JaxServingModel(_variant("jax", kind), path, unique_cap=512)
    pmodel = serve(path, task=_variant("port", kind), unique_cap=512)
    for _ in range(2):
        fb, b = data.batch()
        jinputs, jparams = jmodel._predict_host(fb, b)
        jpreds, jlogits = jmodel._forward(dict(jmodel.pools), jparams,
                                          jinputs, b)
        with torch.inference_mode():
            ppreds, plogits = pmodel._forward(
                pmodel.module, dict(pmodel.pools), pmodel._prepare(fb), b)
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ppreds.numpy(), np.asarray(jpreds),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(pmodel.predict(fb, b), ppreds.numpy())


def test_non_parameter_model_state_is_refused(tmp_path):
    """Non-parameter model state is carried, no longer refused: a JAX
    export of a BatchNorm model (chip_smoke.py's phase 15 module, dropout
    off) serves in the port with its running statistics, equal to the JAX
    ServingModel (rtol 1e-5 / atol 1e-6); the JAX checkpoint restores the
    statistics into a port trainer exactly, and the port's export of that
    state writes the JAX export's model_state.msgpack byte for byte."""
    import chip_smoke
    from monolith_tpu.training import checkpoint as jckpt
    from monolith_tpu_torch.training import checkpoint as pckpt
    from test_torch_library import (TASK as LIB_TASK, jax_library_trainer,
                                    port_library_trainer)
    jt = jax_library_trainer()
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=64, seed=57)
    for i in range(4):
        jt.train_step(*data.batch(), ts=i)
    path = jax_export_model(jt, str(tmp_path / "export"))
    with open(os.path.join(path, "model_state.msgpack"), "rb") as f:
        jbytes = f.read()
    want = convert._flatten(convert.jax_trainer_state(jt)["model_state"])
    assert sorted(want) == [("batch_stats", "bn", "mean"),
                            ("batch_stats", "bn", "var")]
    assert np.abs(want[("batch_stats", "bn", "mean")]).sum() > 0
    pmodel = serve(path, task=chip_smoke.library_task(keep_prob=1.0,
                                                      **LIB_TASK),
                   unique_cap=512)
    got = convert._flatten(convert.model_state_tree(pmodel.module))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jmodel = JaxServingModel(jt.task, path, unique_cap=512)
    for _ in range(2):
        fb, b = data.batch()
        np.testing.assert_allclose(pmodel.predict(fb, b),
                                   jmodel.predict(fb, b), rtol=1e-5,
                                   atol=1e-6)
    jckpt.save(jt, str(tmp_path / "ckpt"))
    pt = port_library_trainer()
    assert pckpt.restore(pt, str(tmp_path / "ckpt")) == 4
    got = convert._flatten(pt.model_state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    ppath = export_model(pt, str(tmp_path / "port_export"))
    with open(os.path.join(ppath, "model_state.msgpack"), "rb") as f:
        assert f.read() == jbytes
