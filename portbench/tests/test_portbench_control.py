"""The control on the card: the reference put in the program's place with
TF32 on, the precision below the configuration's float32 with TF32 off,
fails a number the program passes; so does a loss over half of the batch.
At the configuration's widths and vocabularies, on a batch of 1024 and a
smaller pool.

Run on the card: python -m pytest portbench/tests -m cuda"""

import pytest
import torch

from portbench import compare, control, run
from portbench.tests import small

SIZES = dict(capacity_per_shard=1 << 20, batch_size=1024)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [41, 42, 43])
def test_control_and_fault_fail(card, seed):
    files = run.cell_files(small.CELL)
    files["cfg"].update(SIZES)
    files["traffic"].update(small.TRAFFIC)
    ctx = run.context(small.CELL, files, seed, 1.0, False, device=card,
                      log=lambda s: None)
    out = control.train_readings(ctx, True)
    limits = files["limits"]
    assert compare.judge(out["program"], limits), out["program"]
    assert not compare.judge(out["tf32"], limits), out["tf32"]
    assert not compare.judge(out["half_batch"], limits), out["half_batch"]
