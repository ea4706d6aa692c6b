"""The generator repeats by seed, batch i does not depend on the batches
drawn before it, and each field's ids keep to its vocabulary."""

import json
import os

import numpy as np

from portbench.streams import criteo

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(HERE, "configs", "deepfm_criteo.json")) as f:
    CFG = json.load(f)
SEED = (1 << 33) + 5   # past 32 bits: a run's seed may be


def _same(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k]), k


def test_batches_repeat_by_seed():
    _same(criteo.World(CFG, SEED).batch(3, 64),
          criteo.World(CFG, SEED).batch(3, 64))
    mine = criteo.World(CFG, SEED).batch(3, 64)[0]["C3"]
    other = criteo.World(CFG, SEED + 1).batch(3, 64)[0]["C3"]
    assert not np.array_equal(mine, other)


def test_batch_i_does_not_depend_on_earlier_batches():
    alone = criteo.World(CFG, SEED).batch(7, 64)
    world = criteo.World(CFG, SEED)
    for i in range(7):
        world.batch(i, 64)
    _same(alone, world.batch(7, 64))
    assert not np.array_equal(alone[0]["C3"], world.batch(6, 64)[0]["C3"])


def test_batch_layout():
    fb, b = criteo.World(CFG, 3).batch(0, 4096)
    assert list(fb) == list(CFG["fields"]) and len(fb) == 39
    for f, (name, vocab) in enumerate(CFG["fields"].items()):
        ids = fb[name]
        assert ids.shape == (4096, 1) and ids.dtype == np.int64
        assert np.all(ids >> criteo.SLOT_SHIFT == f + 1)
        low = ids & ((1 << criteo.SLOT_SHIFT) - 1)
        assert low.min() >= 0 and low.max() < vocab
    assert b["label"].dtype == np.float32
    assert set(np.unique(b["label"])) <= {0.0, 1.0}
    assert abs(b["label"].mean() - CFG["positive_rate"]) < 0.03


def test_power_law_ranks():
    ids = criteo.power_law(np.random.default_rng(0), 10_000_000, 1.05,
                           200_000)
    counts = np.bincount(ids[ids < 4])
    # P(k) is the mass of x ** -1.05 on [k + 1, k + 2)
    mass = [(k + 1) ** -0.05 - (k + 2) ** -0.05 for k in range(4)]
    for k in (1, 3):
        want = mass[0] / mass[k]
        assert 0.9 * want < counts[0] / counts[k] < 1.1 * want, k
    assert ids.min() >= 0 and ids.max() < 10_000_000


def test_a_step_stays_under_the_unique_cap():
    w = criteo.World(CFG, SEED)
    for i in (0, 63):
        fb, _ = w.batch(i, CFG["batch_size"])
        n = len(np.unique(np.concatenate([v.ravel() for v in fb.values()])))
        assert n <= CFG["unique_cap"]
