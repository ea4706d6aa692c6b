"""Runnable end-to-end demo of the port (the JAX package's demo.py, the
reference's `demo.py` / local_train), on the card unless `--cpu` is given:

    python -m monolith_tpu_torch.demo --steps 500 --batch_size 1024 \\
        --model_dir /tmp/demo_model

Trains the flagship DeepFM CTR task on the synthetic stream through the
`Estimator`, prints AUC/loss against the generator's Bayes ceiling,
checkpoints and exports for serving. `--realtime` then runs the realtime
loop over localhost gRPC: a `ServingModel` of the export behind a
`ServingAgent` that registers in a `FileDiscovery`, a `SyncClientManager`
that finds it there, 100 streaming steps pushing the touched rows every 20,
and a predict from the replica.

`northstar` trains the fixed-dataset AUC north star: the JAX package's
`demo.NORTHSTAR` knobs (the synthetic generator's seed is the frozen
dataset; the trainer seed pins dense init) through the port's `Estimator`
with its default engine caps (unique_cap = new_cap = 8192). The eval AUC
must land in NORTHSTAR_BAND, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import tempfile

NORTHSTAR = dict(steps=6000, batch_size=1024, num_users=1000, num_items=500,
                 embedding_dim=16, data_seed=7, trainer_seed=0,
                 eval_steps=20)

#: Allowed eval-AUC band (the JAX package's: eval 0.7505 on CPU against the
#: generator's Bayes ceiling 0.7573 when pinned).
NORTHSTAR_BAND = (0.730, 0.768)


def northstar(device=None) -> dict:
    """Train the demo config on the frozen dataset through the Estimator;
    return the metrics {"train_auc", "eval_auc", "train_loss", "eval_loss",
    "bayes_auc", "examples_per_sec"}."""
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.estimator import Estimator, RunnerConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask

    ns = NORTHSTAR
    data = SyntheticCTR(num_users=ns["num_users"],
                        num_items=ns["num_items"],
                        batch_size=ns["batch_size"], seed=ns["data_seed"])
    with tempfile.TemporaryDirectory(prefix="monolith_northstar_") as d:
        est = Estimator(DeepFMTask(embedding_dim=ns["embedding_dim"]),
                        RunnerConfig(model_dir=d, num_shards=1, log_every=0,
                                     seed=ns["trainer_seed"]),
                        device=device)
        result = est.train(iter(data), steps=ns["steps"])
        # the generator's rng advances, so eval sees the held-out
        # continuation
        ev = est.evaluate(iter(data), steps=ns["eval_steps"])
    return {"train_auc": result["auc"], "eval_auc": ev["auc"],
            "train_loss": result["loss"], "eval_loss": ev["loss"],
            "bayes_auc": data.bayes_auc(20000),
            "examples_per_sec": result["examples_per_sec"]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--num_users", type=int, default=5000)
    p.add_argument("--num_items", type=int, default=2000)
    p.add_argument("--embedding_dim", type=int, default=16)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--realtime", action="store_true",
                   help="also run the streaming+serving sync demo")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="K steps per dispatch (bit-identical blocks)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None

    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.estimator import Estimator, RunnerConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask

    model_dir = args.model_dir or tempfile.mkdtemp(prefix="monolith_demo_")
    data = SyntheticCTR(num_users=args.num_users, num_items=args.num_items,
                        batch_size=args.batch_size, seed=0)
    print(f"generator Bayes AUC ceiling: {data.bayes_auc(20000):.4f}")

    task = DeepFMTask(embedding_dim=args.embedding_dim)
    est = Estimator(task, RunnerConfig(
        model_dir=model_dir, num_shards=args.num_shards,
        log_every=max(args.steps // 10, 1),
        enable_realtime_training=args.realtime,
        steps_per_dispatch=args.steps_per_dispatch),
        device=device)
    result = est.train(iter(data), steps=args.steps)
    print(f"train: auc={result['auc']:.4f} loss={result['loss']:.4f} "
          f"ex/s={result['examples_per_sec']:.0f}")
    ev = est.evaluate(iter(data), steps=20)
    print(f"eval:  auc={ev['auc']:.4f} loss={ev['loss']:.4f}")

    export_path = est.export_saved_model(model_dir)
    print(f"exported to {export_path}")
    out = {"train": result, "eval": ev, "export_path": export_path}

    if args.realtime:
        from monolith_tpu_torch.serving import (FileDiscovery, ServingAgent,
                                                ServingModel,
                                                SyncClientManager)
        from monolith_tpu_torch.training.streaming import (StreamingConfig,
                                                           StreamingTrainer)

        disc = FileDiscovery(model_dir + "/discovery")
        model = ServingModel(task, export_path, device=device)
        agent = ServingAgent(model, discovery=disc)
        agent.start()
        sync = SyncClientManager(task.name, discovery=disc)
        try:
            st = StreamingTrainer(est.trainer, sync,
                                  StreamingConfig(sync_interval_steps=20))
            res = st.run(iter(data), max_steps=100)
            print(f"realtime: pushed {res['pushed_rows']} rows over "
                  f"{res['sync_rounds']} sync rounds to {agent.addr}")
            fb, b = data.batch()
            preds = model.predict(fb, b)
            print(f"serving replica predicts: mean={preds.mean():.4f}")
        finally:
            sync.close()
            agent.stop()
        out["realtime"] = res
    return out


if __name__ == "__main__":
    main()
