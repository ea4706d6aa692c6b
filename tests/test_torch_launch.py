"""The port's multi-rank entry points on the CPU: `parallel.launch`, the
CLI's `--num_shards S` from one command, the multi-rank dry run and the
scaling harness.

- `launch` runs a function in S gloo ranks on the CPU and returns their
  values; a rank that fails makes the launch raise with that rank's error
  (the others killed); more ranks than cards, or no card, are refused, as
  the JAX package's `make_mesh(S)` refuses, with no fallback;
- `train.main(["--cpu", "--num_shards", "2" | "4", ...])` at
  init_scale=0.0 prints the loss and AUC of the `--num_shards 1` run
  within rtol 1e-5, and its per-shard checkpoint restores into a JAX
  ShardedTrainer of 2 shards, equal by id;
- a sharded trainer's delta from launched ranks (a KeyError before);
- `dryrun_multichip` at n = 2 prints every case of the JAX function;
- `scaling_bench --cpu` at a tiny size prints the JAX tool's JSON keys.
"""

import json
import os

import numpy as np
import pytest
import torch

from monolith_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from monolith_tpu.parallel import make_mesh as jax_make_mesh
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert, scaling_bench
from monolith_tpu_torch import train as pcli
from monolith_tpu_torch.parallel import dryrun, launch as launch_mod
from monolith_tpu_torch.parallel.launch import RankFailed, launch

torch.set_num_threads(1)

TASK = dict(embedding_dim=8, capacity_per_shard=1024, hidden=[8],
            init_scale=0.0)
CLI = ["--cpu", "--task_args", json.dumps(TASK), "--batch_size", "64",
       "--unique_cap", "256", "--new_cap", "256", "--steps", "4",
       "--eval_steps", "2", "--mode", "train_and_eval", "--log_every", "0"]


# rank bodies (module level: launch imports them by name)

def _reduce(rank, scale):
    import torch.distributed as dist
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    return rank, dist.get_world_size(), float(t) * scale


def _fail_on_one(rank):
    import torch.distributed as dist
    if rank == 1:
        raise RuntimeError("rank one gives up")
    dist.barrier()      # rank 0 waits for a rank that never comes
    return rank


def _sharded_delta(rank, directory):
    """Two steps of a ShardedTrainer and its delta."""
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import ShardedTrainer, make_mesh
    from monolith_tpu_torch.training import checkpoint
    from monolith_tpu_torch.training.trainer import TrainerConfig
    torch.set_num_threads(1)
    tr = ShardedTrainer(DeepFMTask(**dict(TASK, hidden=(8,))), TrainerConfig(
        engine=EngineConfig(num_shards=2, unique_cap=128, new_cap=128),
        log_every=0), make_mesh(device="cpu"))
    data = SyntheticCTR(num_users=40, num_items=20, batch_size=32, seed=5)
    for ts in (1, 2):
        tr.train_step(*data.batch(), ts=ts)
    return checkpoint.save_delta(tr, directory, since_ts=2)


def test_launch_runs_gloo_ranks_on_the_cpu():
    out = launch(_reduce, 3, device="cpu", args=(2.0,))
    assert out == [(r, 3, 12.0) for r in range(3)]


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RankFailed, match="of 2 exited") as e:
        launch(_fail_on_one, 2, device="cpu")
    assert "--- rank 1 ---" in str(e.value)
    assert "rank one gives up" in str(e.value)


def test_more_ranks_than_cards_are_refused(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch(_reduce, 2, args=(1.0,))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pcli.main(["--num_shards", "2", "--steps", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks need 2 cards"):
        launch(_reduce, 2, args=(1.0,))
    with pytest.raises(ValueError, match="4 ranks need 4 cards"):
        pcli.main(["--num_shards", "4", "--steps", "1"])
    with pytest.raises(ValueError, match="backend='gloo'"):
        launch_mod.placement(2, device="cuda:0")
    assert launch_mod.placement(2, backend="gloo", device="cuda:0") == (
        "gloo", ["cuda:0", "cuda:0"])
    assert launch_mod.placement(1) == ("nccl", ["cuda:0"])
    with pytest.raises(ValueError, match="device='cpu' takes gloo"):
        launch_mod.placement(2, backend="nccl", device="cpu")


def _printed(capsys, argv):
    out = pcli.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return out, json.loads(line)


@pytest.fixture(scope="module")
def one_shard():
    return pcli.main(list(CLI))


@pytest.mark.parametrize("S", [2, 4])
def test_cli_num_shards_from_one_command(S, tmp_path, capsys, one_shard):
    """S ranks of ShardedTrainer from one command equal the one-shard
    run; at S = 2 the per-shard checkpoint restores into JAX's
    ShardedTrainer of 2 shards, equal by id."""
    model_dir = str(tmp_path / "m")
    out, printed = _printed(capsys, CLI + ["--num_shards", str(S),
                                           "--model_dir", model_dir])
    assert set(printed) == {"train", "eval"}
    for phase in ("train", "eval"):
        for k in ("loss", "auc"):
            np.testing.assert_allclose(out[phase][k], one_shard[phase][k],
                                       rtol=1e-5, err_msg=f"{phase} {k}")
    step_dir = os.path.join(model_dir, "ckpt-4", "tables")
    assert sorted(os.listdir(step_dir)) == [f"sparse-s{s}.npz"
                                            for s in range(S)]
    if S != 2:
        return
    jt = JaxShardedTrainer(
        JaxDeepFMTask(**dict(TASK, hidden=tuple(TASK["hidden"]))),
        JaxTrainerConfig(engine=JaxEngineConfig(num_shards=2, unique_cap=256,
                                                new_cap=256), log_every=0),
        jax_make_mesh(2))
    jt.train_step(*JaxSyntheticCTR(num_users=30, num_items=20, batch_size=64,
                                   seed=9).batch(), ts=0)
    assert jckpt.restore(jt, model_dir) == 4
    st = convert.jax_trainer_state(jt)
    for s in range(2):
        z = np.load(os.path.join(step_dir, f"sparse-s{s}.npz"))
        assert len(z["fids"]) > 0
        rows = jt.engine.stores["sparse"][s].lookup(z["fids"])
        assert (rows >= 0).all()
        dim = z["pool"].shape[1]
        np.testing.assert_array_equal(st["tables"]["sparse"][s][rows, :dim],
                                      z["pool"][z["rows"]])


def test_sharded_delta_from_launched_ranks(tmp_path):
    """A ShardedTrainer's delta: each rank writes its shard's file (the
    port raised KeyError here before: it read the single-shard store
    view, empty at S = 2)."""
    paths = launch(_sharded_delta, 2, device="cpu",
                   args=(str(tmp_path / "d"),))
    assert paths[0] == paths[1]
    assert sorted(os.listdir(paths[0])) == ["meta.json", "sparse-s0.npz",
                                            "sparse-s1.npz"]
    with open(os.path.join(paths[0], "meta.json")) as f:
        assert json.load(f)["tables"]["sparse"]["shards"] == 2


def test_dryrun_multichip_on_two_ranks(capsys):
    out = dryrun.main(["--cpu", "2"])
    printed = capsys.readouterr().out.strip().splitlines()
    cases = ["a2a", "allgather", "multihost", "multihost-bf16-multislot"]
    assert [line.split(": OK")[0] for line in printed] == [
        f"dryrun_multichip(2, {c})" for c in cases]
    assert list(out) == cases
    assert all(np.isfinite(v) for c in out.values() for v in c.values())


def test_scaling_bench_cpu_json(capsys):
    out = scaling_bench.main(["--cpu", "--sizes", "1,2", "--exchange", "a2a",
                              "32"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert printed["ranks_share_one_device"] and "not scaling" in \
        printed["note"]
    for n in (1, 2):
        cell = printed[f"mesh{n}"]
        assert set(cell) == {"examples_per_sec", "per_device_efficiency",
                             "total_vs_mesh1", "ms_per_step",
                             "host_prepare_ms", "per_device_step_comm"}
        assert len(cell["host_prepare_ms"]) == n
        assert set(cell["per_device_step_comm"]) == {
            "a2a_bytes", "allgather_bytes", "reduce_scatter_bytes",
            "collective_launches"}
    assert printed["mesh1"]["per_device_step_comm"]["collective_launches"] \
        == 0
    comm = printed["mesh2"]["per_device_step_comm"]
    assert comm["a2a_bytes"] > 0 and comm["collective_launches"] >= 2
