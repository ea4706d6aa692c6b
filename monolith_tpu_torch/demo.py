"""The fixed-dataset AUC north star, trained by the port.

    python -m monolith_tpu_torch.demo            # on the card
    python -m monolith_tpu_torch.demo --device cpu

Same pinned knobs as the JAX package's `demo.NORTHSTAR` (the synthetic
generator's seed is the frozen dataset; the trainer seed pins dense init),
trained through the port's Trainer with the JAX estimator's default engine
caps (unique_cap = new_cap = 8192). The eval AUC must land in
NORTHSTAR_BAND, as the JAX package's does.
"""

from __future__ import annotations

import argparse

NORTHSTAR = dict(steps=6000, batch_size=1024, num_users=1000, num_items=500,
                 embedding_dim=16, data_seed=7, trainer_seed=0,
                 eval_steps=20)

#: Allowed eval-AUC band (the JAX package's: eval 0.7505 on CPU against the
#: generator's Bayes ceiling 0.7573 when pinned).
NORTHSTAR_BAND = (0.730, 0.768)


def northstar(device=None) -> dict:
    """Train the demo config on the frozen dataset; return the metrics
    {"train_auc", "eval_auc", "train_loss", "eval_loss", "bayes_auc",
    "examples_per_sec"}."""
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

    ns = NORTHSTAR
    data = SyntheticCTR(num_users=ns["num_users"],
                        num_items=ns["num_items"],
                        batch_size=ns["batch_size"], seed=ns["data_seed"])
    trainer = Trainer(DeepFMTask(embedding_dim=ns["embedding_dim"]),
                      TrainerConfig(engine=EngineConfig(unique_cap=8192,
                                                        new_cap=8192),
                                    seed=ns["trainer_seed"], log_every=0),
                      device=device)
    result = trainer.train(iter(data), steps=ns["steps"])
    # the generator's rng advances, so eval sees the held-out continuation
    ev = trainer.evaluate(iter(data), max_steps=ns["eval_steps"])
    return {"train_auc": result["auc"], "eval_auc": ev["auc"],
            "train_loss": result["loss"], "eval_loss": ev["loss"],
            "bayes_auc": data.bayes_auc(20000),
            "examples_per_sec": result["examples_per_sec"]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    r = northstar(device=args.device)
    lo, hi = NORTHSTAR_BAND
    print(f"eval auc {r['eval_auc']:.4f} (band [{lo}, {hi}], bayes "
          f"{r['bayes_auc']:.4f}); train auc {r['train_auc']:.4f}")


if __name__ == "__main__":
    main()
