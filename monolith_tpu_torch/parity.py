"""The port's side of the JAX package's AUC head-to-head (monolith_tpu/
parity.py): `MovieRankingTask` trained on the frozen batches of the vendored
MovieLens-format sample, whose eval AUC must lie within PARITY_BAND of the
JAX package's `train_monolith` on the same batches. (The JAX package's
plain-TensorFlow twin of the reference demo model stays its own test.)

    python -m monolith_tpu_torch.parity [--cpu] [--seeds N]

prints the eval AUC of trainer seeds 0 .. N-1; `chip_smoke.py` holds the
card's against the JAX package's number.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

#: The JAX package's frozen configuration (monolith_tpu/parity.py:34-36)
#: and its engine caps (:82-84).
PARITY = dict(steps=800, batch_size=512, eval_steps=15, embedding_dim=32,
              hidden=(256, 64), lr=0.05, seed=0, data_seed=7, caps=4096)

#: Allowed |port AUC - JAX AUC| (monolith_tpu/parity.py:42).
PARITY_BAND = 0.015

MOVIELENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "movielens", "ratings.dat")


def frozen_data(cfg=None):
    """The train and eval batches both packages consume: the temporal split
    of the vendored sample, the train split shuffled by `data_seed`."""
    from monolith_tpu_torch.data.movielens import MovieLensRatings
    cfg = cfg or PARITY
    tr = MovieLensRatings(path=MOVIELENS, batch_size=cfg["batch_size"],
                          split="train", seed=cfg["data_seed"])
    ev = MovieLensRatings(path=MOVIELENS, batch_size=cfg["batch_size"],
                          split="eval")
    return (list(itertools.islice(iter(tr), cfg["steps"])),
            list(itertools.islice(iter(ev), cfg["eval_steps"])))


def train_port(train, evals, cfg=None, device=None, seed=None) -> float:
    """Train the port's MovieRankingTask on the frozen batches (one
    `train_step` each) and return its eval AUC."""
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.movie_ranking import MovieRankingTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    cfg = cfg or PARITY
    trainer = Trainer(MovieRankingTask(
        embedding_dim=cfg["embedding_dim"], hidden=cfg["hidden"],
        embedding_lr=cfg["lr"], dense_lr=cfg["lr"]), TrainerConfig(
        engine=EngineConfig(unique_cap=cfg["caps"], new_cap=cfg["caps"]),
        log_every=0, seed=cfg["seed"] if seed is None else seed),
        device=device)
    for fb, b in train:
        trainer.train_step(fb, b)
    return trainer.evaluate(iter(evals))["auc"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.add_argument("--seeds", type=int, default=1)
    args = p.parse_args(argv)
    train, evals = frozen_data()
    for seed in range(args.seeds):
        t0 = time.time()
        auc = train_port(train, evals, device="cpu" if args.cpu else None,
                         seed=seed)
        print(f"seed {seed}: eval AUC {auc!r} ({time.time() - t0:.1f} s)",
              flush=True)


if __name__ == "__main__":
    main()
