"""MovieLens ratings ingestion — the reference demo's real-data path.

The reference demo trains on MovieLens via tfds + string hashing (ref
markdown/demo/ml_dataset.py:20-30: movie_title/user_id hashed to fids,
user_rating as the label). This module (the port's copy of the JAX package's) is the equivalent for
the on-disk MovieLens formats, with no TF dependency:

  * ml-1m / ml-10m `ratings.dat`:  UserID::MovieID::Rating::Timestamp
  * ml-100k `u.data`:              user \t item \t rating \t ts

`MovieLensRatings` streams (fid_batch, batch) pairs for tasks with
(user, item) features — e.g. `--task movie_ranking --data
movielens:<path>` through the training CLI. Ids are slot-encoded into
the fid space (slot in the high bits, ref fid.h:22) rather than hashed
to 2^63 buckets: the collisionless host store makes hashing-for-width
unnecessary.

Labels: `label_threshold` >= 1 binarizes (rating >= threshold -> 1.0,
the standard CTR reading of MovieLens); 0 keeps the raw rating for the
demo's regression head (demo_model.py:62 MSE).

This image has no network access, so `examples/movielens/` vendors a
small sample IN THIS EXACT FORMAT, generated once by `generate_sample`
(a fixed-seed latent-factor model with MovieLens-like marginals —
Zipf-popular items, heavy-tailed user activity, 1..5 ratings from
user x item affinity + biases). It stands in for the real download to
exercise the identical ingestion path; point `--data movielens:` at a
real `ratings.dat` to train on actual MovieLens.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

USER_SLOT = 1 << 54
ITEM_SLOT = 2 << 54


def _parse_line(line: str) -> Optional[Tuple[int, int, float, int]]:
    line = line.strip()
    if not line:
        return None
    sep = "::" if "::" in line else ("\t" if "\t" in line else ",")
    parts = line.split(sep)
    if len(parts) < 3:
        return None
    try:
        ts = int(parts[3]) if len(parts) > 3 else 0
        return int(parts[0]), int(parts[1]), float(parts[2]), ts
    except ValueError:
        return None  # header or malformed row


def load_ratings(path: str) -> Dict[str, np.ndarray]:
    """Parse a MovieLens ratings file into columnar arrays
    {user, item, rating, ts} (int64/int64/float32/int64)."""
    users: List[int] = []
    items: List[int] = []
    ratings: List[float] = []
    tss: List[int] = []
    with open(path) as f:
        for line in f:
            row = _parse_line(line)
            if row is None:
                continue
            users.append(row[0])
            items.append(row[1])
            ratings.append(row[2])
            tss.append(row[3])
    if not users:
        raise ValueError(f"no parseable ratings in {path}")
    return {"user": np.asarray(users, np.int64),
            "item": np.asarray(items, np.int64),
            "rating": np.asarray(ratings, np.float32),
            "ts": np.asarray(tss, np.int64)}


@dataclasses.dataclass
class MovieLensRatings:
    """Batched (fid_batch, batch) stream over a MovieLens ratings file.

    eval_fraction holds out the LAST fraction (by file order — MovieLens
    files are roughly time-ordered, so this is a temporal split);
    `split="train"` shuffles the rest per epoch, `split="eval"` streams
    the holdout once per epoch unshuffled."""
    path: str = ""
    batch_size: int = 512
    label_threshold: float = 4.0  # >=1: binarize; 0: raw rating label
    feature_names: Tuple[str, str] = ("user_id", "item_id")
    split: str = "train"  # train | eval | all
    eval_fraction: float = 0.1
    shuffle: bool = True
    seed: int = 0
    epochs: int = 0  # 0 = loop forever

    def __post_init__(self):
        cols = load_ratings(self.path)
        n = len(cols["user"])
        cut = n - int(n * self.eval_fraction)
        sl = {"train": slice(0, cut), "eval": slice(cut, n),
              "all": slice(0, n)}[self.split]
        self._user = cols["user"][sl] + USER_SLOT
        self._item = cols["item"][sl] + ITEM_SLOT
        if self.label_threshold >= 1:
            self._label = (cols["rating"][sl]
                           >= self.label_threshold).astype(np.float32)
        else:
            self._label = cols["rating"][sl].astype(np.float32)
        self._rng = np.random.default_rng(self.seed)

    def __len__(self) -> int:
        return len(self._label)

    def __iter__(self) -> Iterator:
        n = len(self._label)
        if n < self.batch_size:
            # epochs=0 would otherwise spin forever yielding nothing
            raise ValueError(
                f"split {self.split!r} of {self.path} has {n} ratings — "
                f"fewer than batch_size={self.batch_size}; lower the batch "
                f"size or eval_fraction")
        epoch = 0
        while self.epochs == 0 or epoch < self.epochs:
            order = (self._rng.permutation(n)
                     if self.shuffle and self.split == "train"
                     else np.arange(n))
            for s in range(0, n - self.batch_size + 1, self.batch_size):
                idx = order[s:s + self.batch_size]
                fu, fi = self.feature_names
                fid_batch = {fu: self._user[idx][:, None],
                             fi: self._item[idx][:, None]}
                batch = {"label": self._label[idx]}
                yield fid_batch, batch
            epoch += 1


def generate_sample(path: str, num_users: int = 600, num_items: int = 400,
                    num_ratings: int = 80_000, seed: int = 42) -> str:
    """Write a MovieLens-1m-format `ratings.dat` sample (fixed seed).

    Latent-factor generative model with MovieLens-like marginals: item
    popularity ~ Zipf, user activity heavy-tailed, rating = clip(round(
    mu + user_bias + item_bias + <u, v>), 1, 5). Used once to vendor
    examples/movielens/ratings.dat; kept so the sample is reproducible
    and tests can generate fresh files."""
    rng = np.random.default_rng(seed)
    d = 6
    uvec = rng.normal(size=(num_users + 1, d)) / np.sqrt(d)
    ivec = rng.normal(size=(num_items + 1, d)) / np.sqrt(d)
    ubias = 0.5 * rng.normal(size=num_users + 1)
    ibias = 0.5 * rng.normal(size=num_items + 1)
    # heavy-tailed activity/popularity
    u = (rng.zipf(1.8, size=num_ratings * 2) - 1) % num_users + 1
    v = (rng.zipf(1.4, size=num_ratings * 2) - 1) % num_items + 1
    keep = rng.permutation(len(u))[:num_ratings]
    u, v = u[keep], v[keep]
    aff = np.einsum("bd,bd->b", uvec[u], ivec[v])
    raw = 3.3 + ubias[u] + ibias[v] + 1.8 * aff + 0.35 * rng.normal(
        size=num_ratings)
    rating = np.clip(np.round(raw), 1, 5).astype(np.int64)
    ts = np.sort(rng.integers(956_700_000, 1_046_400_000,
                              size=num_ratings))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(num_ratings):
            f.write(f"{u[i]}::{v[i]}::{rating[i]}::{ts[i]}\n")
    return path
