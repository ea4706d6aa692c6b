"""Tests of the port that need the card: K1/K2 against their plain versions
on CUDA tensors, and a few train steps on the card against the CPU from one
carried state. They skip without CUDA. On a machine with a card (and no
JAX) run them with:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

TF32 is turned off for the matrix products, so the card's dense tower runs
in full f32 like the CPU's.
"""

import numpy as np
import pytest
import torch

from monolith_tpu_torch import convert
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.ops import scatter as ops
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,width", [(1, 128), (1000, 128), (4097, 128),
                                     (300, 4), (300, 256)])
def test_kernels_match_plain_on_card(card, n, width):
    g = torch.Generator(device=card).manual_seed(n)
    cap = 8192
    pool = torch.randn((cap, width), generator=g, device=card)
    rows = torch.randperm(cap, generator=g, device=card)[:n].to(torch.int32)
    rows[::3] = -1
    values = torch.randn((n, width), generator=g, device=card)
    before = ops.gather_rows.launches, ops.scatter_rows.launches
    out = ops.gather_rows(pool, rows)
    assert torch.equal(out, ops.gather_rows_plain(pool, rows))
    a, b = pool.clone(), pool.clone()
    ops.scatter_rows(a, rows, values)
    ops.scatter_rows_plain(b, rows, values)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert (ops.gather_rows.launches, ops.scatter_rows.launches) == \
        (before[0] + 1, before[1] + 1)


def test_card_steps_match_cpu(card):
    def make(device):
        return Trainer(DeepFMTask(capacity_per_shard=4096, hidden=(32, 16),
                                  init_scale=0.0),
                       TrainerConfig(engine=EngineConfig(unique_cap=512,
                                                         new_cap=512),
                                     log_every=0), device=device)

    data = SyntheticCTR(num_users=400, num_items=300, batch_size=64, seed=2)
    batches = [data.batch() for _ in range(5)]
    cpu = make("cpu")
    for i in range(2):
        cpu.train_step(*batches[i], ts=i)
    gpu = make(card)
    convert.load_state(gpu, convert.export_state(cpu))
    for i in range(2, 5):
        lc = cpu.train_step(*batches[i], ts=i)["loss"].item()
        lg = gpu.train_step(*batches[i], ts=i)["loss"].item()
        # the card's index_add backward uses atomics: order varies
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
