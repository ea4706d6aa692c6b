"""The multi-hot stream of dcnv2_criteo1tb: batch i is drawn from (seed,
i) alone, each feature's bag has its hotness and its ids lie in the rows
this card holds of its table, the dense values are log(1 + count), and a
step of the configuration stays under every table's unique cap."""

import json
import os

import numpy as np

from portbench.reference import dlrm_dcnv2 as model
from portbench.streams import criteo_multihot

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(HERE, "configs", "dcnv2_criteo1tb.json")) as f:
    CFG = json.load(f)
SEED = (1 << 33) + 5   # past 32 bits: a run's seed may be


def _same(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k]), k


def test_batch_i_is_drawn_from_seed_and_i_alone():
    _same(criteo_multihot.World(CFG, SEED).batch(3, 64),
          criteo_multihot.World(CFG, SEED).batch(3, 64))
    world = criteo_multihot.World(CFG, SEED)
    for i in range(3):
        world.batch(i, 64)
    _same(world.batch(3, 64), criteo_multihot.World(CFG, SEED).batch(3, 64))
    other = criteo_multihot.World(CFG, SEED + 1).batch(3, 64)[0]["C21"]
    assert not np.array_equal(world.batch(3, 64)[0]["C21"], other)
    assert not np.array_equal(world.batch(4, 64)[0]["C21"],
                              world.batch(3, 64)[0]["C21"])


def test_batch_layout_and_held_slices():
    B = 4096
    fb, b = criteo_multihot.World(CFG, 3).batch(0, B)
    held = model.held_rows(CFG)
    assert list(fb) == [f"C{i + 1}" for i in range(26)]
    assert sum(held.values()) == 51_883_621
    assert held["C1"] == held["C21"] == 10_000_000
    assert held["C11"] == 766_989 and held["C2"] == 39060
    for (name, ids), hot in zip(fb.items(), CFG["multi_hot_sizes"]):
        assert ids.shape == (B, hot) and ids.dtype == np.int64
        assert ids.min() >= 0 and ids.max() < held[name], name
    assert b["dense"].shape == (B, 13) and b["dense"].dtype == np.float32
    assert np.all(b["dense"] >= 0) and np.all(np.isfinite(b["dense"]))
    counts = np.expm1(b["dense"].astype(np.float64))
    assert np.allclose(counts, np.round(counts), atol=1e-3 * (1 + counts))
    assert b["label"].dtype == np.float32
    assert set(np.unique(b["label"])) <= {0.0, 1.0}
    assert abs(b["label"].mean() - CFG["positive_rate"]) < 0.015


def test_a_step_stays_under_the_unique_caps():
    w = criteo_multihot.World(CFG, SEED)
    for i in (0, 63):
        fb, _ = w.batch(i, CFG["batch_size"])
        for name, ids in fb.items():
            assert len(np.unique(ids)) <= CFG["unique_caps"][name], (i, name)
