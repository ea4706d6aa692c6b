"""The FLOP and byte counts, worked out by hand for the configuration."""

import json
import os

from portbench import flops
from portbench.reference import deepfm

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_deepfm_flops():
    # tower (39 x 10 = 390) -> 400 -> 400 -> 400 -> 1:
    # 2 x (156000 + 160000 + 160000 + 400); FM over 39 fields of 10: 2 sums
    # as multiply-adds, 2 x 2 x 390; forward + backward (twice) = 3x
    per = 3 * (2 * (390 * 400 + 400 * 400 + 400 * 400 + 400 * 1)
               + 2 * 2 * 39 * 10)
    assert per == 2_863_080
    assert deepfm.train_flops_per_example(_cfg("deepfm_criteo")) == per
    assert 8192 * per == 23_454_351_360


def test_row_bytes():
    # bias 1 + vector 10 + the vector's Adagrad accumulator 10, f32
    assert flops.row_state_bytes(_cfg("deepfm_criteo")) == 84
    assert flops.row_kernel_bytes(1000, _cfg("deepfm_criteo")) == 168_000


def test_peaks():
    assert flops.peak("NVIDIA H100 80GB HBM3") == {"f32_flops": 67e12,
                                                   "bytes_per_s": 3.35e12}
    assert flops.peak("cpu") is None
