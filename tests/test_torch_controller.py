"""The port's training controller on the CPU: the JAX controller's status
keys on the same configuration, pause / resume around a `train` call on
another thread, and a save request honoured at the next hook; a client of
either package calls a controller of the other."""

import threading
import time

import numpy as np
import pytest
import torch

from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training.controller import \
    ControllerClient as JaxControllerClient
from monolith_tpu.training.controller import \
    TrainingController as JaxTrainingController
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training import checkpoint
from monolith_tpu_torch.training.controller import (ControllerClient,
                                                    TrainingController)
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

TASK = dict(embedding_dim=8, capacity_per_shard=4096, hidden=(16, 8))
TIMEOUT = 10.0


def port_trainer():
    return Trainer(DeepFMTask(**TASK), TrainerConfig(
        engine=EngineConfig(unique_cap=512, new_cap=512), log_every=0,
        seed=3), device="cpu")


def jax_trainer():
    return JaxTrainer(JaxDeepFMTask(**TASK), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=512, new_cap=512),
        log_every=0, seed=3))


def data(seed=72):
    return SyntheticCTR(num_users=50, num_items=30, batch_size=64, seed=seed)


def status_of(trainer, controller_cls, client_cls, steps=5):
    ctl = controller_cls(trainer)
    addr = ctl.start()
    try:
        trainer.train(iter(data()), steps=steps, hooks=[ctl.hook])
        client = client_cls(addr, timeout_s=TIMEOUT)
        status = client.get_status()
        client.close()
    finally:
        ctl.stop()
    return status


def test_status_keys_are_the_jax_controllers():
    """The same configuration and stream in both packages: the same status
    keys, the same step and table size, losses that agree."""
    mine = status_of(port_trainer(), TrainingController, ControllerClient)
    theirs = status_of(jax_trainer(), JaxTrainingController,
                       JaxControllerClient)
    assert sorted(mine) == sorted(theirs)
    assert mine["step"] == theirs["step"] == 5 and mine["paused"] == 0
    assert mine["table:sparse:s0:size"] == theirs["table:sparse:s0:size"] > 0
    assert np.isfinite(mine["loss"]) and np.isfinite(mine["auc"])
    np.testing.assert_allclose(mine["loss"], theirs["loss"], rtol=0.05)


@pytest.mark.parametrize("client_cls", [ControllerClient,
                                        JaxControllerClient])
def test_pause_resume_and_save(tmp_path, client_cls):
    trainer = port_trainer()
    ctl = TrainingController(trainer, ckpt_dir=str(tmp_path))
    addr = ctl.start()
    stream = iter(data())
    try:
        client = client_cls(addr, timeout_s=TIMEOUT)
        assert client.stop_training() == {"ok": 1, "paused": 1}
        worker = threading.Thread(target=trainer.train, args=(stream,),
                                  kwargs={"steps": 3, "hooks": [ctl.hook]})
        worker.start()
        # the first step runs, then its hook holds the loop
        deadline = time.time() + TIMEOUT
        while trainer.step < 1 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)
        assert trainer.step == 1 and worker.is_alive()
        status = client.get_status()
        assert status["paused"] == 1 and status["step"] == 1
        assert client.resume_training() == {"ok": 1, "paused": 0}
        worker.join(TIMEOUT)
        assert not worker.is_alive() and trainer.step == 3
        # a save request lands at the next hook, after that hook's step
        assert checkpoint.latest_step(str(tmp_path)) is None
        assert client.save_checkpoint() == {"ok": 1}
        trainer.train(stream, steps=2, hooks=[ctl.hook])
        assert checkpoint.latest_step(str(tmp_path)) == 4
        assert client.get_status()["step"] == 5
        client.close()
    finally:
        ctl._paused.clear()
        ctl.stop()


def test_save_without_a_directory_is_refused():
    trainer = port_trainer()
    ctl = TrainingController(trainer)
    addr = ctl.start()
    try:
        client = ControllerClient(addr, timeout_s=TIMEOUT)
        assert client.save_checkpoint() == {
            "ok": 0, "error": "no ckpt_dir configured"}
        trainer.train(iter(data()), steps=1, hooks=[ctl.hook])
        assert client.get_status()["step"] == 1
        client.close()
    finally:
        ctl.stop()
