"""The port's front door against the JAX package's, on the CPU: the
`Estimator`, the training CLI (`python -m monolith_tpu_torch.train`), the
demo, and the MovieRanking task that the CLI's real-data command trains.

- A checkpoint that one package's CLI trains on framed files is evaluated
  by the other package's CLI (`--mode eval`, a fresh process state that
  restores it and reads the files from their start) and by its own: loss
  to rtol 1e-5, AUC to 1e-4, both directions. The tasks use
  `init_scale=0.0`, because new-row init draws differ between the packages
  (Philox against threefry).
- MovieRanking, both heads, from state carried by `convert.py`: 3 steps
  with losses to rtol 1e-5, then `train` and `evaluate` with the trainer's
  metrics, whose AUC takes a rating label as JAX's does.
- `Estimator.predict` from carried state equals JAX's (rtol 1e-5).
- What the port refuses: a task name outside the zoo (every task of the
  JAX CLI's zoo is ported), `num_shards=2` in one process (the CLI starts
  the ranks itself), `--realtime`
  (item 9b), and the card's default where CUDA is missing.
"""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from monolith_tpu import train as jcli
from monolith_tpu.data.example import Example as JaxExample
from monolith_tpu.data.framing import write_example_file as jax_write
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.estimator import Estimator as JaxEstimator
from monolith_tpu.estimator import RunnerConfig as JaxRunnerConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.models.movie_ranking import \
    MovieRankingTask as JaxMovieRankingTask
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert, demo
from monolith_tpu_torch import train as pcli
from monolith_tpu_torch.data.movielens import MovieLensRatings, generate_sample
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.estimator import Estimator, RunnerConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.models.movie_ranking import MovieRankingTask
from monolith_tpu_torch.serving.engine import ServingModel
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

TASK = dict(embedding_dim=8, capacity_per_shard=2048, hidden=(16, 8),
            init_scale=0.0)
B = 32


def small_estimator(model_dir=""):
    return Estimator(DeepFMTask(**TASK), RunnerConfig(
        model_dir=model_dir, unique_cap=512, new_cap=512, log_every=0),
        device="cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """12 batches of 32 SyntheticCTR examples as one framed mtex file (the
    -1 pads dropped, as a producer writes them)."""
    d = tmp_path_factory.mktemp("files")
    gen = SyntheticCTR(num_users=50, num_items=30, batch_size=B, seed=4)
    exs = []
    for _ in range(12):
        fb, b = gen.batch()
        for i in range(B):
            exs.append(JaxExample(
                features={k: v[i][v[i] >= 0] for k, v in fb.items()},
                labels=np.asarray([b["label"][i]], np.float32)))
    jax_write(str(d / "part-0.rec"), exs)
    return str(d)


def run_cli(cli, argv):
    """(returned dict, the printed JSON line) of one CLI call."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = cli.main(argv)
    return out, json.loads(buf.getvalue().strip().splitlines()[-1])


def cli_argv(files, model_dir, mode, **extra):
    argv = ["--task", "deepfm",
            "--task_args", json.dumps({**TASK, "hidden": list(TASK["hidden"])}),
            "--data", f"files:{files}/part-*.rec", "--batch_size", str(B),
            "--unique_cap", "512", "--new_cap", "512", "--log_every", "0",
            "--mode", mode, "--model_dir", model_dir, "--cpu"]
    for k, v in extra.items():
        argv += [f"--{k}", str(v)]
    return argv


@pytest.mark.parametrize("trainer_cli", ["jax", "port"])
def test_cli_checkpoint_evaluates_alike_in_both_packages(files, tmp_path,
                                                         trainer_cli):
    """One package's CLI trains 8 steps (blocks of 2) into --model_dir;
    each package's CLI then evaluates it with --mode eval on the same file
    from its start."""
    model_dir = str(tmp_path / "model")
    trains = {"jax": jcli, "port": pcli}[trainer_cli]
    out, printed = run_cli(trains, cli_argv(files, model_dir, "train",
                                            steps=8, steps_per_dispatch=2))
    assert set(printed) == {"train"} and np.isfinite(out["train"]["loss"])
    assert set(printed["train"]) == {"auc", "loss", "examples_per_sec"}
    assert os.path.exists(os.path.join(model_dir, "CHECKPOINT"))
    evals = {}
    for name, cli in (("jax", jcli), ("port", pcli)):
        out, printed = run_cli(cli, cli_argv(files, model_dir, "eval",
                                             eval_steps=3))
        assert set(printed) == {"eval"}
        assert set(printed["eval"]) == {"auc", "loss"}
        evals[name] = out["eval"]
    np.testing.assert_allclose(evals["port"]["loss"], evals["jax"]["loss"],
                               rtol=1e-5)
    assert abs(evals["port"]["auc"] - evals["jax"]["auc"]) <= 1e-4
    assert 0.0 <= evals["port"]["auc"] <= 1.0


def test_cli_train_and_eval_on_files_exports_for_serving(files, tmp_path):
    """The JAX package's TestTrainCLI on the port: zoo task + JSON
    overrides, framed-file data, train + eval, checkpoint under
    --model_dir, and an export that the port's ServingModel loads."""
    out, printed = run_cli(pcli, cli_argv(
        files, str(tmp_path / "model"), "train_and_eval", steps=8,
        eval_steps=3, export_dir=str(tmp_path / "export")))
    assert set(printed) == {"train", "eval", "export_path"}
    assert np.isfinite(out["train"]["loss"]) and np.isfinite(
        out["eval"]["loss"])
    assert (tmp_path / "model" / "CHECKPOINT").exists()
    model = ServingModel(DeepFMTask(**TASK), out["export_path"],
                         device="cpu")
    fb, b = SyntheticCTR(num_users=50, num_items=30, batch_size=B,
                         seed=4).batch()
    preds = model.predict(fb, b)
    assert preds.shape == (B,) and np.isfinite(preds).all()


def test_cli_movielens_command(tmp_path):
    """The README's real-data command, small: both packages' CLIs train
    movie_ranking on a MovieLens-format file and print the same keys."""
    path = generate_sample(str(tmp_path / "ratings.dat"), num_users=60,
                           num_items=40, num_ratings=3000, seed=1)
    printed = {}
    for name, cli in (("jax", jcli), ("port", pcli)):
        out, printed[name] = run_cli(cli, [
            "--task", "movie_ranking", "--data", f"movielens:{path}",
            "--mode", "train_and_eval", "--steps", "20", "--eval_steps", "2",
            "--batch_size", "64", "--log_every", "0", "--cpu"])
        assert np.isfinite(out["eval"]["loss"]) and out["eval"]["auc"] > 0.5
    assert ({k: set(v) for k, v in printed["port"].items()}
            == {k: set(v) for k, v in printed["jax"].items()})


def test_zoo_refuses_a_model_not_ported_yet():
    """Every task of the JAX CLI's zoo is ported; a name outside the zoo
    (and not module:Class) is refused."""
    assert set(jcli.ZOO) == set(pcli.ZOO)
    assert not hasattr(pcli, "NOT_PORTED")
    with pytest.raises(SystemExit, match="--task must be one of"):
        pcli.build_task("nope", {})
    with pytest.raises(SystemExit, match="--task must be one of"):
        pcli.main(["--task", "nope", "--cpu"])
    assert isinstance(pcli.build_task(
        "monolith_tpu_torch.models.deepfm:DeepFMTask", {"hidden": [4]}),
        DeepFMTask)


def test_sharded_runs_are_refused():
    """An Estimator of several shards in one process, with no group, is
    refused and names what starts the ranks; the CLI starts them itself
    (`--num_shards 2 --cpu`: two gloo ranks of a ShardedTrainer,
    tests/test_torch_launch.py; a group of N ranks from another launcher
    gets a MultiHostTrainer: tests/test_torch_multihost.py)."""
    with pytest.raises(ValueError, match="train.main .* parallel.launch"):
        Estimator(DeepFMTask(**TASK), RunnerConfig(num_shards=2),
                  device="cpu")
    out = pcli.main(["--num_shards", "2", "--cpu", "--steps", "1",
                     "--batch_size", str(B), "--unique_cap", "512",
                     "--new_cap", "512", "--log_every", "0", "--task_args",
                     json.dumps({**TASK, "hidden": list(TASK["hidden"])})])
    assert np.isfinite(out["train"]["loss"])


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Estimator(DeepFMTask(**TASK))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.main(["--steps", "1"])


def test_estimator_train_eval_predict_export(tmp_path):
    data = SyntheticCTR(num_users=60, num_items=30, batch_size=128, seed=73)
    est = small_estimator(str(tmp_path / "m"))
    res = est.train(iter(data), steps=20)
    assert set(res) == {"auc", "loss", "examples_per_sec"}
    assert (tmp_path / "m" / "ckpt-20").exists()
    ev = est.evaluate(iter(data), steps=5)
    assert 0 <= ev["auc"] <= 1
    preds = list(est.predict(iter(data), steps=2))
    assert len(preds) == 2 and preds[0].shape == (128,)
    assert isinstance(preds[0], np.ndarray)
    path = est.export_saved_model(str(tmp_path / "exp"))
    assert os.path.exists(os.path.join(path, "meta.json"))


def test_estimator_restores_from_model_dir_at_the_first_batch(tmp_path):
    data = SyntheticCTR(num_users=60, num_items=30, batch_size=128, seed=74)
    small_estimator(str(tmp_path)).train(iter(data), steps=10)
    est2 = small_estimator(str(tmp_path))
    assert est2.trainer.step == 0  # decided now, restored at the data
    est2.train(iter(data), steps=5)
    assert est2.trainer.step == 15


def test_estimator_hooks_and_periodic_checkpoints(tmp_path):
    data = SyntheticCTR(num_users=60, num_items=30, batch_size=64, seed=75)
    est = Estimator(DeepFMTask(**TASK), RunnerConfig(
        model_dir=str(tmp_path), unique_cap=512, new_cap=512, log_every=0,
        save_checkpoints_steps=4, steps_per_dispatch=2), device="cpu")
    seen = []
    est.train(iter(data), steps=8, hooks=[lambda t, out: seen.append(t.step)])
    assert seen == [2, 4, 6, 8]
    assert {"ckpt-4", "ckpt-8"} <= set(os.listdir(tmp_path))


def test_estimator_predict_equals_jax_from_carried_state():
    data = SyntheticCTR(num_users=60, num_items=30, batch_size=128, seed=76)
    train = [data.batch() for _ in range(4)]
    tests = [data.batch() for _ in range(2)]
    jest = JaxEstimator(JaxDeepFMTask(**TASK), JaxRunnerConfig(
        unique_cap=512, new_cap=512, log_every=0))
    jest.train(iter(train), steps=4)
    est = small_estimator()
    convert.load_state(est.trainer, convert.jax_trainer_state(jest.trainer))
    got = list(est.predict(iter(tests)))
    ref = list(jest.predict(iter(tests)))
    assert len(got) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7)
    # and back: the port's state read out equals what JAX holds
    state = convert.export_state(est.trainer)
    jstate = convert.jax_trainer_state(jest.trainer)
    for t in state["tables"]:
        np.testing.assert_array_equal(
            state["tables"][t].reshape(jstate["tables"][t].shape),
            jstate["tables"][t])


# ----------------------------------------------------------------------
# MovieRanking
# ----------------------------------------------------------------------

MR = dict(embedding_dim=8, capacity_per_shard=1024, hidden=(16, 8),
          init_scale=0.0)


@pytest.fixture(scope="module")
def ml_path(tmp_path_factory):
    return generate_sample(str(tmp_path_factory.mktemp("ml") / "ratings.dat"),
                           num_users=80, num_items=50, num_ratings=2000,
                           seed=2)


@pytest.mark.parametrize("head", ["ctr", "rating"])
def test_movie_ranking_matches_jax_from_carried_state(ml_path, head):
    data = list(MovieLensRatings(path=ml_path, batch_size=64, seed=3,
                                 label_threshold=4.0 if head == "ctr" else 0,
                                 epochs=1))[:8]
    jt = JaxTrainer(JaxMovieRankingTask(head=head, **MR), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=128, new_cap=128),
        log_every=0, seed=5))
    inputs, _ = jt.engine.prepare_batch(data[0][0], ts=0)
    jt._maybe_init(inputs, data[0][1])
    pt = Trainer(MovieRankingTask(head=head, **MR), TrainerConfig(
        engine=EngineConfig(unique_cap=128, new_cap=128), log_every=0,
        seed=5), device="cpu")
    assert {n for n, _ in pt.module.named_parameters()} == {
        f"ratings.dense_{i}.{w}" for i in range(3) for w in ("weight", "bias")}
    convert.load_state(pt, convert.jax_trainer_state(jt))
    for i, (fb, b) in enumerate(data[:3]):
        lp = pt.train_step(fb, b, ts=i)["loss"].item()
        lj = float(np.asarray(jt.train_step(fb, b, ts=i)["loss"]))
        np.testing.assert_allclose(lp, lj, rtol=1e-5)
    # the train loop's on-device metrics and evaluate take the label as
    # JAX's do (a raw 1..5 rating for the rating head)
    rp = pt.train(iter(data[3:6]), steps=3)
    rj = jt.train(iter(data[3:6]), steps=3)
    np.testing.assert_allclose(rp["loss"], rj["loss"], rtol=1e-5)
    assert abs(rp["auc"] - rj["auc"]) <= 1e-4
    ep, ej = pt.evaluate(iter(data[6:])), jt.evaluate(iter(data[6:]))
    np.testing.assert_allclose(ep["loss"], ej["loss"], rtol=1e-5)
    assert abs(ep["auc"] - ej["auc"]) <= 1e-4


# ----------------------------------------------------------------------
# demo
# ----------------------------------------------------------------------

def test_demo_main_trains_through_the_estimator(tmp_path, capsys):
    demo.main(["--steps", "4", "--batch_size", "64", "--num_users", "50",
               "--num_items", "30", "--embedding_dim", "4", "--cpu",
               "--model_dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "train: auc=" in text and "exported to" in text
    assert (tmp_path / "CHECKPOINT").exists()


def test_demo_realtime_waits_for_the_serving_agent(tmp_path, capsys):
    """`--realtime` (refused until the serving agent was ported) now runs
    the realtime loop: the agent is up and registered before the
    streaming run pushes to it, and gone after."""
    out = demo.main(["--realtime", "--cpu", "--steps", "4", "--batch_size",
                     "64", "--num_users", "50", "--num_items", "30",
                     "--embedding_dim", "4", "--model_dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert out["realtime"]["pushed_rows"] > 0
    assert f"realtime: pushed {out['realtime']['pushed_rows']} rows over " \
        f"6 sync rounds to localhost:" in text
    assert not [f for f in os.listdir(tmp_path / "discovery")
                if f.endswith(".json")]
