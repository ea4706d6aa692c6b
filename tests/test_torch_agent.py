"""The port's realtime loop over gRPC on the CPU: discovery, the serving
agent and its client, the parameter-sync client and manager, the version
watcher, the row-sharded router and `demo --realtime`, each held against
the in-process model and against the JAX package (a JAX client calls a port
agent and the reverse, on localhost ports the OS picks). Every agent is
stopped in `finally`; every RPC has a timeout of a few seconds."""

import contextlib
import os
import time

import grpc
import numpy as np
import pytest
import torch

from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.serving import FileDiscovery as JaxDiscovery
from monolith_tpu.serving import ParameterSyncClient as JaxSyncClient
from monolith_tpu.serving import ServingAgent as JaxAgent
from monolith_tpu.serving import ServingClient as JaxClient
from monolith_tpu.serving import ServingModel as JaxServingModel
from monolith_tpu.serving import SyncClientManager as JaxSyncManager
from monolith_tpu.serving.router import ShardedServingRouter as JaxRouter
from monolith_tpu_torch import convert, demo, serialization
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.embedding.host_store import shard_of_batch
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.serving import (FileDiscovery, ParameterSyncClient,
                                        ServingAgent, ServingClient,
                                        ServingModel, SyncClientManager,
                                        VersionWatcher, codec, export_model)
from monolith_tpu_torch.serving.param_sync import chunk_rows
from monolith_tpu_torch.serving.router import ShardedServingRouter
from monolith_tpu_torch.training.streaming import (StreamingConfig,
                                                   StreamingTrainer)
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

TASK = dict(embedding_dim=8, capacity_per_shard=4096, hidden=(16, 8))
TIMEOUT = 10.0


def make_task(**kw):
    return DeepFMTask(**{**TASK, **kw})


def make_trainer(record_touch=False, seed=51, **task_kw):
    cfg = TrainerConfig(engine=EngineConfig(unique_cap=512, new_cap=512,
                                            record_touch=record_touch),
                        log_every=0, seed=seed)
    return Trainer(make_task(**task_kw), cfg, device="cpu")


def train_some(trainer, steps=12, seed=51, batch_size=128):
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=batch_size,
                        seed=seed)
    for _ in range(steps):
        trainer.train_step(*data.batch())
    return data


def serve(path, task=None, **kw):
    return ServingModel(task or make_task(), path, device="cpu", **kw)


def trainer_rows(trainer, fids):
    """The trainer's embedding rows of `fids` [n, dim] f32."""
    pool = ptable.params_np(trainer.engine.tables["sparse"],
                            trainer.table_states["sparse"])
    rows = trainer.engine.stores["sparse"].lookup(fids)
    assert (rows >= 0).all()
    return pool[rows]


@contextlib.contextmanager
def running(*agents):
    """Start the agents; stop every one that started, whatever happens."""
    started = []
    try:
        for a in agents:
            a.start()
            started.append(a)
        yield [a.addr for a in agents]
    finally:
        for a in started:
            a.stop()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(trainer, its data stream, the path of its export): 12 steps of the
    small DeepFM on the CPU."""
    trainer = make_trainer()
    data = train_some(trainer)
    path = export_model(trainer, str(tmp_path_factory.mktemp("export")))
    return trainer, data, path


# ----------------------------------------------------------------------
# discovery
# ----------------------------------------------------------------------

class TestDiscovery:
    def test_register_query_ttl(self, tmp_path):
        d = FileDiscovery(str(tmp_path), ttl_seconds=0.2)
        d.register("serving", 0, "host:1")
        d.register("serving", 1, "host:2")
        assert d.query("serving") == {0: "host:1", 1: "host:2"}
        assert d.query("other") == {}
        time.sleep(0.3)
        assert d.query("serving") == {}
        d.register("serving", 0, "host:1")
        d.deregister("serving", 0, "host:1")
        d.deregister("serving", 0, "host:1")    # twice is fine
        assert d.query("serving") == {}

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_registrations_cross_the_packages(self, tmp_path, writer):
        w, r = ((FileDiscovery, JaxDiscovery) if writer == "port"
                else (JaxDiscovery, FileDiscovery))
        wd = w(str(tmp_path), ttl_seconds=0.3)
        rd = r(str(tmp_path), ttl_seconds=0.3)
        wd.register("serving", 3, "localhost:1234")
        wd.heartbeat("router", 0, "localhost:99")
        assert sorted(os.listdir(tmp_path)) == ["router-0.json",
                                                "serving-3.json"]
        assert rd.query("serving") == {3: "localhost:1234"}
        assert rd.query("router") == {0: "localhost:99"}
        time.sleep(0.4)
        assert rd.query("serving") == {} and wd.query("serving") == {}
        wd.heartbeat("serving", 3, "localhost:1234")
        assert rd.query("serving") == {3: "localhost:1234"}
        rd.deregister("serving", 3, "localhost:1234")
        assert wd.query("serving") == {}


# ----------------------------------------------------------------------
# the agent over gRPC
# ----------------------------------------------------------------------

class TestAgentRpc:
    def test_predict_lookup_and_push_over_grpc(self, exported):
        trainer, data, path = exported
        model = serve(path)
        with running(ServingAgent(model)) as (addr,):
            client = ServingClient(addr, timeout_s=TIMEOUT)
            fb, b = data.batch()
            got = client.predict(fb, {"label": b["label"]})
            assert got.shape == (128,) and got.dtype == np.float32
            np.testing.assert_array_equal(got, model.predict(fb, b))
            fids = trainer.engine.stores["sparse"].save()[0][:20]
            ask = np.concatenate([fids, [123456789]])
            np.testing.assert_array_equal(client.lookup("sparse", ask),
                                          model.lookup_rows("sparse", ask))
            sync = ParameterSyncClient(addr, timeout_s=TIMEOUT)
            new = np.array([123456789, 987654321], np.int64)
            vals = np.arange(18, dtype=np.float32).reshape(2, 9)
            assert sync.push("m", "sparse", new, vals) == 2
            assert sync.push("m", "sparse", new[:0], vals[:0]) == 0
            np.testing.assert_array_equal(client.lookup("sparse", new), vals)
            client.close()
            sync.close()

    def test_a_jax_client_calls_a_port_agent(self, exported):
        _, data, path = exported
        model = serve(path)
        jmodel = JaxServingModel(JaxDeepFMTask(**TASK), path)
        with running(ServingAgent(model)) as (addr,):
            client = JaxClient(addr, timeout_s=TIMEOUT)
            fb, b = data.batch()
            np.testing.assert_allclose(client.predict(fb, b),
                                       jmodel.predict(fb, b), rtol=1e-5,
                                       atol=1e-6)
            new = np.array([5, 6, 7], np.int64) + 10 ** 12
            vals = np.full((3, 9), 0.5, np.float32)
            assert JaxSyncClient(addr, timeout_s=TIMEOUT).push(
                "m", "sparse", new, vals) == 3
            np.testing.assert_array_equal(client.lookup("sparse", new), vals)
            np.testing.assert_array_equal(model.lookup_rows("sparse", new),
                                          vals)
            client.close()

    def test_a_port_client_calls_a_jax_agent(self, exported):
        _, data, path = exported
        model = serve(path)
        jmodel = JaxServingModel(JaxDeepFMTask(**TASK), path)
        with running(JaxAgent(jmodel, port=0)) as (addr,):
            client = ServingClient(addr, timeout_s=TIMEOUT)
            fb, b = data.batch()
            np.testing.assert_allclose(client.predict(fb, b),
                                       model.predict(fb, b), rtol=1e-5,
                                       atol=1e-6)
            new = np.array([5, 6, 7], np.int64) + 10 ** 12
            vals = np.full((3, 9), -0.25, np.float32)
            assert ParameterSyncClient(addr, timeout_s=TIMEOUT).push(
                "m", "sparse", new, vals) == 3
            np.testing.assert_array_equal(client.lookup("sparse", new), vals)
            np.testing.assert_array_equal(jmodel.lookup_rows("sparse", new),
                                          vals)
            client.close()

    @pytest.mark.parametrize("source", ["port", "jax"])
    def test_reload_dense_with_either_trainers_bytes(self, tmp_path, source):
        """ReloadDense over gRPC with a dense.msgpack from either package's
        trainer: the agent's module then holds exactly those bytes, and its
        predictions move."""
        trainer = make_trainer()
        data = train_some(trainer, steps=5)
        model = serve(export_model(trainer, str(tmp_path)))
        if source == "port":
            train_some(trainer, steps=10, seed=52)
            dense = serialization.to_bytes(
                convert.dense_tree(trainer.module.named_parameters()))
        else:
            import jax
            from flax import serialization as flax_ser
            from monolith_tpu.embedding.engine import (
                EngineConfig as JaxEngineConfig)
            from monolith_tpu.training.trainer import Trainer as JaxTrainer
            from monolith_tpu.training.trainer import (
                TrainerConfig as JaxTrainerConfig)
            jt = JaxTrainer(JaxDeepFMTask(**TASK), JaxTrainerConfig(
                engine=JaxEngineConfig(num_shards=1, unique_cap=512,
                                       new_cap=512), log_every=0, seed=7))
            jdata = SyntheticCTR(num_users=80, num_items=40, batch_size=128,
                                 seed=53)
            for _ in range(3):
                jt.train_step(*jdata.batch())
            dense = flax_ser.to_bytes(jax.device_get(jt.params))
        with running(ServingAgent(model)) as (addr,):
            client = ServingClient(addr, timeout_s=TIMEOUT)
            fb, b = data.batch()
            before = client.predict(fb, b)
            client.reload_dense(dense)
            after = client.predict(fb, b)
            client.close()
        assert serialization.to_bytes(convert.dense_tree(
            model.module.named_parameters())) == dense
        assert not np.allclose(before, after)


# ----------------------------------------------------------------------
# the push's chunks: the reference's fault and the port's repair
# ----------------------------------------------------------------------

#: a full chunk of the JAX client at dim 17: 4 MiB // (68 + 8) rows
JAX_CHUNK = (4 << 20) // (17 * 4 + 8)
BIG_PUSH = 2 * JAX_CHUNK + 1


@pytest.fixture(scope="module")
def dim17(tmp_path_factory):
    """An export of a DeepFM with 17-float rows (DeepFM's width at
    embedding_dim 16) and the headroom that BIG_PUSH new rows need."""
    trainer = make_trainer(embedding_dim=16)
    train_some(trainer, steps=3)
    path = export_model(trainer, str(tmp_path_factory.mktemp("dim17")))
    live = trainer.engine.stores["sparse"].size()
    rng = np.random.default_rng(0)
    fids = np.arange(BIG_PUSH, dtype=np.int64) + 10 ** 12
    vals = rng.standard_normal((BIG_PUSH, 17)).astype(np.float32)
    return path, (BIG_PUSH + 4096) / live, fids, vals


def _agent(package, path, headroom):
    if package == "port":
        return ServingAgent(serve(path, make_task(embedding_dim=16),
                                  headroom=headroom))
    return JaxAgent(JaxServingModel(JaxDeepFMTask(**{**TASK,
                                                     "embedding_dim": 16}),
                                    path, headroom=headroom), port=0)


def test_a_request_holds_the_header_and_its_rows_within_the_limit():
    n = chunk_rows("m", "sparse", (17,), 4 << 20)
    assert n == JAX_CHUNK - 2

    def packed(k):
        return len(codec.pack({"model_name": "m", "table": "sparse",
                               "fids": np.zeros(k, np.int64),
                               "embeddings": np.zeros((k, 17), np.float32)}))
    assert packed(n) <= 4 << 20 < packed(n + 1)
    # the JAX client's full chunk is over the limit by its header
    assert packed(JAX_CHUNK) > 4 << 20
    with pytest.raises(ValueError):
        chunk_rows("m", "sparse", (17,), 100)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_push_beyond_one_chunk_is_acked_whole(dim17, package):
    """2 x 55,188 + 1 rows of 17 floats: three requests, each within
    gRPC's 4 MiB receive limit, acked whole by an agent of either
    package; every row lands."""
    path, headroom, fids, vals = dim17
    agent = _agent(package, path, headroom)
    with running(agent) as (addr,):
        assert ParameterSyncClient(addr, timeout_s=60.0).push(
            "m", "sparse", fids, vals) == BIG_PUSH
        mgr = SyncClientManager("m", static_targets=[addr])
        assert mgr.push("sparse", fids[:7], vals[:7] + 1) == {addr: 7}
        got = agent.model.lookup_rows("sparse", fids)
    np.testing.assert_array_equal(got[7:], vals[7:])
    np.testing.assert_array_equal(got[:7], vals[:7] + 1)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_the_jax_client_loses_a_push_beyond_one_chunk(dim17, package):
    """The reference's fault, pinned: its client sizes a chunk without the
    codec header, the first request exceeds 4 MiB, the server refuses it
    with RESOURCE_EXHAUSTED and the manager records -1 for the round."""
    path, headroom, fids, vals = dim17
    agent = _agent(package, path, headroom)
    with running(agent) as (addr,):
        with pytest.raises(grpc.RpcError) as e:
            JaxSyncClient(addr, timeout_s=60.0).push("m", "sparse", fids,
                                                     vals)
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert JaxSyncManager("m", static_targets=[addr]).push(
            "sparse", fids, vals) == {addr: -1}
        assert agent.model.table_sizes()["sparse"] < BIG_PUSH


# ----------------------------------------------------------------------
# versions and the streaming loop
# ----------------------------------------------------------------------

def test_version_watcher_swaps_to_new_exports(tmp_path):
    trainer = make_trainer()
    data = train_some(trainer, steps=10)
    base = str(tmp_path)
    path_a = export_model(trainer, base)
    model = serve(path_a)
    watcher = VersionWatcher(model, base, poll_s=999)   # manual polls
    assert not watcher.poll_once()
    fb, b = data.batch()
    preds_a = model.predict(fb, b)
    train_some(trainer, steps=12, seed=52)
    path_b = export_model(trainer, base)
    assert watcher.poll_once() and watcher.swaps == 1
    assert model.step == trainer.step == 22
    preds_b = model.predict(fb, b)
    np.testing.assert_array_equal(preds_b, serve(path_b).predict(fb, b))
    assert not np.allclose(preds_a, preds_b)
    assert not watcher.poll_once()
    # a push after the swap applies to the new version
    assert model.apply_delta("sparse", np.array([999999], np.int64),
                             np.ones((1, 9), np.float32)) == 1
    # the agent's own watcher thread follows a third export
    agent = ServingAgent(model, watch_dir=base, watch_poll_s=0.05)
    with running(agent) as (addr,):
        train_some(trainer, steps=3, seed=53)
        export_model(trainer, base)
        deadline = time.time() + TIMEOUT
        while model.step != trainer.step and time.time() < deadline:
            time.sleep(0.05)
        assert model.step == trainer.step == 25
        client = ServingClient(addr, timeout_s=TIMEOUT)
        np.testing.assert_allclose(client.predict(fb, b),
                                   trainer.predict(fb, b).numpy(),
                                   rtol=1e-4, atol=1e-5)
        client.close()
    assert not agent.watcher.is_alive()


def test_streaming_through_a_sync_client_manager(tmp_path):
    """A StreamingTrainer pushes through a real SyncClientManager that
    finds the agent through discovery: every serving row equals the
    trainer's, and the agent deregisters when it stops."""
    trainer = make_trainer(record_touch=True)
    data = train_some(trainer, steps=5, seed=52)
    model = serve(export_model(trainer, str(tmp_path)), headroom=4.0)
    disc = FileDiscovery(str(tmp_path / "disc"))
    acks = []

    class Spy(SyncClientManager):
        def push(self, table, fids, values):
            out = super().push(table, fids, values)
            acks.append((len(fids), out))
            return out

    with running(ServingAgent(model, discovery=disc)) as (addr,):
        assert disc.query("serving") == {0: addr}
        st = StreamingTrainer(trainer, Spy("m", discovery=disc),
                              StreamingConfig(sync_interval_steps=10))
        res = st.run(iter(data), max_steps=40)
    assert disc.query("serving") == {}
    assert res["steps"] == 40 and res["sync_rounds"] == 5
    assert res["pushed_rows"] == sum(n for n, _ in acks) > 0
    assert all(out == {addr: n} for n, out in acks)
    fids = trainer.engine.stores["sparse"].save()[0]
    np.testing.assert_array_equal(model.lookup_rows("sparse", fids),
                                  trainer_rows(trainer, fids))


def test_sync_manager_follows_discovery(exported, tmp_path):
    """Targets come and go with their registrations; a push reaches every
    live one; close() drops every channel."""
    _, _, path = exported
    disc = FileDiscovery(str(tmp_path))
    agents = [ServingAgent(serve(path), discovery=disc, replica_index=i)
              for i in range(2)]
    mgr = SyncClientManager("m", discovery=disc, static_targets=[])
    fids = np.array([10 ** 12], np.int64)
    vals = np.ones((1, 9), np.float32)
    with running(agents[0]) as (a0,):
        assert mgr.refresh_targets() == [a0]
        with running(agents[1]) as (a1,):
            assert sorted(mgr.refresh_targets()) == sorted([a0, a1])
            assert mgr.push("sparse", fids, vals) == {a0: 1, a1: 1}
        assert mgr.push("sparse", fids, vals) == {a0: 1}
        assert list(mgr._clients) == [a0]
        mgr.close()
        assert mgr._clients == {}
        # a closed manager opens channels again at its next push
        assert mgr.push("sparse", fids, vals) == {a0: 1}
        mgr.close()


# ----------------------------------------------------------------------
# row-sharded serving
# ----------------------------------------------------------------------

class TestShardedServing:
    def test_two_shard_router_equals_the_single_model(self, exported):
        trainer, data, path = exported
        single = serve(path)
        shards = {s: serve(path, shard_index=s, num_row_shards=2)
                  for s in range(2)}
        sizes = [m.table_sizes()["sparse"] for m in shards.values()]
        assert sum(sizes) == single.table_sizes()["sparse"] and min(sizes) > 0
        router = ShardedServingRouter(make_task(), path, shards,
                                      device="cpu")
        assert router.step == 12 and router.num_row_shards == 2
        for _ in range(3):
            fb, b = data.batch()
            np.testing.assert_array_equal(router.predict(fb, b),
                                          single.predict(fb, b))
        router.close()

    def test_router_over_grpc_equals_the_single_model(self, exported):
        _, data, path = exported
        single = serve(path)
        agents = [ServingAgent(serve(path, shard_index=s, num_row_shards=2))
                  for s in range(2)]
        with running(*agents) as addrs:
            clients = {s: ServingClient(a, timeout_s=TIMEOUT)
                       for s, a in enumerate(addrs)}
            router = ShardedServingRouter(make_task(), path, clients,
                                          unique_cap=512, device="cpu")
            for _ in range(2):
                fb, b = data.batch()
                np.testing.assert_array_equal(router.predict(fb, b),
                                              single.predict(fb, b))
            router.close()
            for c in clients.values():
                c.close()

    def test_concurrent_routed_predicts(self, exported):
        """Predicts from 6 threads on one router, with a short switch
        interval: each equals the single model's on its own batch."""
        import sys
        import threading
        _, data, path = exported
        single = serve(path)
        router = ShardedServingRouter(make_task(), path, {
            s: serve(path, shard_index=s, num_row_shards=2)
            for s in range(2)}, device="cpu")
        batches = [data.batch() for _ in range(6)]
        want = [single.predict(fb, b) for fb, b in batches]
        got, errors = {}, []

        def work(i):
            try:
                for _ in range(3):
                    got[i] = router.predict(*batches[i])
            except Exception as e:  # reported below
                errors.append(e)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads) and not errors
        for i in range(6):
            np.testing.assert_array_equal(got[i], want[i])
        router.close()

    def test_router_agrees_with_the_jax_router(self, exported):
        _, data, path = exported
        jtask = JaxDeepFMTask(**TASK)
        jrouter = JaxRouter(jtask, path, {
            s: JaxServingModel(jtask, path, shard_index=s, num_row_shards=2)
            for s in range(2)})
        router = ShardedServingRouter(make_task(), path, {
            s: serve(path, shard_index=s, num_row_shards=2)
            for s in range(2)}, device="cpu")
        for _ in range(2):
            fb, b = data.batch()
            np.testing.assert_allclose(router.predict(fb, b),
                                       jrouter.predict(fb, b), rtol=1e-5,
                                       atol=1e-6)
        router.close()

    def test_router_refuses_what_it_cannot_serve(self, exported, tmp_path):
        _, data, path = exported
        shards = {s: serve(path, shard_index=s, num_row_shards=2)
                  for s in range(2)}
        with pytest.raises(ValueError, match="no replica for row shard 1"):
            ShardedServingRouter(make_task(), path, {0: shards[0]},
                                 num_row_shards=2, device="cpu")
        router = ShardedServingRouter(make_task(), path, shards,
                                      unique_cap=16, device="cpu")
        with pytest.raises(ValueError, match="exceeds unique_cap=16"):
            router.predict(*data.batch())
        router.close()
        # an export with non-parameter state (BatchNorm's statistics) loads
        # in an agent and in a router, and serves what the trainer predicts
        import chip_smoke
        from test_torch_library import TASK as LIB_TASK
        from test_torch_library import port_library_trainer
        lt = port_library_trainer()
        bn_data = train_some(lt, steps=4)
        bn_path = export_model(lt, str(tmp_path / "with_state"))
        assert os.path.exists(os.path.join(bn_path, "model_state.msgpack"))
        bn_task = chip_smoke.library_task(keep_prob=1.0, **LIB_TASK)
        model = serve(bn_path, task=bn_task, unique_cap=512)
        fb, b = bn_data.batch()
        want = lt.predict(fb, b).numpy()
        agent = ServingAgent(model)
        with running(agent) as (addr,):
            client = ServingClient(addr, timeout_s=TIMEOUT)
            np.testing.assert_allclose(client.predict(fb, b), want,
                                       rtol=1e-5, atol=1e-6)
        bn_router = ShardedServingRouter(bn_task, bn_path, {0: model},
                                         unique_cap=512, device="cpu")
        np.testing.assert_allclose(bn_router.predict(fb, b), want,
                                   rtol=1e-5, atol=1e-6)
        bn_router.close()

    def test_push_routed_lands_on_the_owning_shard(self, exported, tmp_path):
        _, _, path = exported
        models = [serve(path, shard_index=s, num_row_shards=2)
                  for s in range(2)]
        disc = FileDiscovery(str(tmp_path / "disc"))
        agents = [ServingAgent(m, discovery=disc, replica_index=s)
                  for s, m in enumerate(models)]
        fids = np.arange(10 ** 12, 10 ** 12 + 256, dtype=np.int64)
        vals = np.random.default_rng(0).standard_normal(
            (len(fids), 9)).astype(np.float32)
        owner = shard_of_batch(fids, 2)
        with running(*agents) as addrs:
            for mgr in (SyncClientManager("m", discovery=disc),
                        SyncClientManager("m", static_targets=addrs)):
                acks = mgr.push_routed("sparse", fids, vals,
                                       num_row_shards=2)
                assert acks == {addrs[s]: int((owner == s).sum())
                                for s in range(2)}
        for s, m in enumerate(models):
            mine = owner == s
            np.testing.assert_array_equal(
                m.lookup_rows("sparse", fids[mine]), vals[mine])
            np.testing.assert_array_equal(
                m.lookup_rows("sparse", fids[~mine]), 0.0)


# ----------------------------------------------------------------------
# the user's entry point
# ----------------------------------------------------------------------

def test_demo_realtime_on_the_cpu(tmp_path, capsys):
    out = demo.main(["--realtime", "--cpu", "--steps", "20",
                     "--batch_size", "64", "--num_users", "60",
                     "--num_items", "30", "--embedding_dim", "4",
                     "--model_dir", str(tmp_path)])
    res = out["realtime"]
    assert res["steps"] == 100 and res["sync_rounds"] == 6
    assert res["pushed_rows"] > 0
    assert out["export_path"] == os.path.join(str(tmp_path), "export-20")
    printed = capsys.readouterr().out
    assert f"realtime: pushed {res['pushed_rows']} rows over 6 sync rounds" \
        in printed
    assert "serving replica predicts: mean=" in printed
    # the agent deregistered when it stopped
    assert FileDiscovery(str(tmp_path / "discovery")).query("serving") == {}
