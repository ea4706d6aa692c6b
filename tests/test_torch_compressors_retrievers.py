"""The port's serving compressors and quantization-aware retrievers against
the JAX package's, on the CPU.

Compressors (numpy in both packages) on the same rows, made from a seed:
every array of `compress` and the result of `decompress` equal bit for
bit. Retrievers: FakeQuant's forward equal exactly, ties at half a step and
the clip to [-128, 127] included, its backward exactly the incoming
gradient; HashNet's forward to rtol 1e-6 at steps 0, 999, 1000 and 250000
(tanh and pow come from two libraries) and its backward to rtol 1e-5 / atol
5e-5 (1 - tanh^2 cancels where tanh saturates). Then 3 carried train
steps of a small DeepFM whose vector segment retrieves through FakeQuant:
losses to rtol 1e-6, live pool rows to atol 1e-6, state carried by
convert.py. The JAX trainer's first 3 steps draw non-zero vectors
(init_scale 0.3); the 3 compared steps see only ids those steps admitted,
so neither package draws an init there (their PRNGs differ).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.embedding import compressors as jcomp
from monolith_tpu.embedding import retrievers as jret
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding import compressors as pcomp
from monolith_tpu_torch.embedding import retrievers as pret
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.embedding.spec import TableSegment, TableSpec
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 30.0], size=(
        shape[0], 1))).astype(np.float32)
    if shape[0] > 2:
        rows[1] = 0.0          # an all-zero row: the scale's lower clamp
        rows[2, ::2] *= -1.0
    return rows


@pytest.mark.parametrize("shape", [(64, 16), (5, 1), (33, 7), (0, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", sorted(jcomp.NAMED_COMPRESSORS))
def test_compressor_matches_jax_bit_for_bit(name, shape):
    rows = _rows(shape, seed=len(name) + shape[0])
    jc, pc = jcomp.NAMED_COMPRESSORS[name](), pcomp.NAMED_COMPRESSORS[name]()
    assert pc.name == jc.name == name
    jblob, pblob = jc.compress(rows), pc.compress(rows)
    assert sorted(pblob) == sorted(jblob)
    for k in jblob:
        a, b = np.asarray(pblob[k]), np.asarray(jblob[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    jout, pout = jc.decompress(jblob), pc.decompress(pblob)
    assert pout.dtype == jout.dtype == np.float32
    assert pout.tobytes() == jout.tobytes()


def test_segment_default_compressor_is_fp32_and_registry_is_whole():
    assert TableSegment(dim=4).compressor == pcomp.Fp32()
    assert sorted(pcomp.NAMED_COMPRESSORS) == sorted(jcomp.NAMED_COMPRESSORS)
    assert sorted(pret.NAMED_RETRIEVERS) == sorted(jret.NAMED_RETRIEVERS)


# ----------------------------------------------------------------------
# retrievers
# ----------------------------------------------------------------------

def _fq_inputs(r):
    """Values on and around the half-step ties, beyond the clip on both
    sides, zeros of both signs, and a random spread."""
    s = np.float32(r / 128.0)
    k = np.arange(-140, 141, dtype=np.float32)
    ties = (k + np.float32(0.5)) * s
    rng = np.random.default_rng(3)
    x = np.concatenate([
        ties, np.nextafter(ties, np.float32(np.inf)),
        np.nextafter(ties, np.float32(-np.inf)), k * s,
        np.array([0.0, -0.0, 5 * r, -5 * r, 1e-9, -1e-9], np.float32),
        rng.normal(size=500).astype(np.float32) * np.float32(r)])
    return x.astype(np.float32).reshape(-1, 1)


@pytest.mark.parametrize("kind", ["torch", "numpy"])
@pytest.mark.parametrize("r", [1.0, 0.5, 4.0])
def test_fake_quant_forward_matches_jax_exactly(r, kind):
    x = _fq_inputs(r)
    ref = np.asarray(jret.FakeQuant(r=r).retrieve(jnp.asarray(x), 0))
    fq = pret.FakeQuant(r=r)
    out = (fq.retrieve(torch.from_numpy(x), 0).numpy() if kind == "torch"
           else fq.retrieve(x, 0))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    # the grid: whole steps inside [-128, 127] steps
    n = out / np.float32(r / 128.0)
    assert n.min() == -128 and n.max() == 127
    np.testing.assert_array_equal(n, np.round(n))


def test_fake_quant_backward_is_the_incoming_gradient():
    x = _fq_inputs(1.0)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jret.FakeQuant().retrieve(v, 0)
                                    * jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (pret.FakeQuant().retrieve(xt, 0) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), g)
    np.testing.assert_array_equal(np.asarray(jg), g)


HASHNET = dict(amplitude=1.5, init_scale=1.0, max_scale=10.0, step_size=1000,
               gamma=0.005, power=0.5)


@pytest.mark.parametrize("step", [0, 999, 1000, 250000])
def test_hash_net_matches_jax(step):
    """Forward (torch and numpy inputs) rtol 1e-6, backward rtol 1e-5; the
    scale holds between multiples of step_size and is capped."""
    x = np.random.default_rng(step).normal(size=(64, 8)).astype(np.float32)
    jh, ph = jret.HashNet(**HASHNET), pret.HashNet(**HASHNET)
    np.testing.assert_allclose(ph.scale(step), float(jh.scale(step)),
                               rtol=1e-6)
    ref = np.asarray(jh.retrieve(jnp.asarray(x), jnp.int32(step)))
    np.testing.assert_allclose(
        ph.retrieve(torch.from_numpy(x), step).numpy(), ref, rtol=1e-6,
        atol=1e-7)
    out_np = ph.retrieve(x, step)
    assert out_np.dtype == np.float32
    np.testing.assert_allclose(out_np, ref, rtol=1e-6, atol=1e-7)
    jg = jax.grad(lambda v: jnp.sum(jh.retrieve(v, jnp.int32(step)) ** 2))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (ph.retrieve(xt, step) ** 2).sum().backward()
    # 1 - tanh^2 cancels where tanh saturates: a few ulps of tanh (6e-8
    # each) times 2 * amplitude^2 * scale (45 at the capped scale) is the
    # absolute floor
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=5e-5)


def test_hash_net_scale_schedule():
    h = pret.HashNet(**HASHNET)
    assert h.scale(0) == h.scale(999) == 1.0
    assert h.scale(1000) == h.scale(1999) > 1.0
    assert h.scale(250000) == h.scale(10 ** 7) == 10.0
    assert isinstance(h.scale(5), float)


def test_raw_retriever_is_identity():
    x = torch.ones(3, 2)
    assert pret.Retriever().retrieve(x, 0) is x


def test_engine_retrieve_unique_applies_segments_in_place():
    """Identity for a table without retrievers (the same tensor comes
    back); otherwise each segment's columns go through its retriever."""
    segs = (TableSegment(dim=1), TableSegment(dim=4,
                                              retriever=pret.FakeQuant()))
    eng = EmbeddingEngine(
        [TableSpec("q", 64, segs), TableSpec("raw", 64, (TableSegment(dim=3),))],
        [FeatureConfig("a", "q", 1), FeatureConfig("b", "raw", 1)],
        EngineConfig(unique_cap=8, new_cap=8), device="cpu")
    bufs = {"q": torch.rand(8, 5) - 0.5, "raw": torch.rand(8, 3)}
    out = eng.retrieve_unique(bufs, step=0)
    assert out["raw"] is bufs["raw"]
    assert torch.equal(out["q"][:, :1], bufs["q"][:, :1])
    assert torch.equal(out["q"][:, 1:],
                       pret.FakeQuant().retrieve(bufs["q"][:, 1:], 0))


# ----------------------------------------------------------------------
# a trainer whose vector segment retrieves through FakeQuant
# ----------------------------------------------------------------------

TASK = dict(embedding_dim=8, capacity_per_shard=4096, hidden=(16, 8),
            init_scale=0.3)


def quant_task(base_cls, retriever):
    class QuantTask(base_cls):
        def tables(self):
            t = super().tables()[0]
            vec = dataclasses.replace(t.segments[1], retriever=retriever)
            return [dataclasses.replace(t, segments=(t.segments[0], vec))]
    return QuantTask(**TASK)


@pytest.fixture(scope="module")
def quant_run():
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=128, seed=21)
    batches = [data.batch() for _ in range(3)]
    rng = np.random.default_rng(22)
    for fb, b in batches[:3]:   # the same ids in other pairings, new labels
        batches.append(({k: np.roll(v, i + 1, axis=0)
                         for i, (k, v) in enumerate(sorted(fb.items()))},
                        {"label": rng.integers(0, 2, 128).astype(np.float32),
                         "hist_len": b["hist_len"]}))
    jt = JaxTrainer(quant_task(JaxDeepFMTask, jret.FakeQuant(r=0.25)),
                    JaxTrainerConfig(engine=JaxEngineConfig(
                        num_shards=1, unique_cap=512, new_cap=512),
                        log_every=0))
    for i in range(3):
        jt.train_step(*batches[i], ts=100 + i)
    pt = Trainer(quant_task(DeepFMTask, pret.FakeQuant(r=0.25)),
                 convert.port_trainer_config(jt.config), device="cpu")
    convert.load_state(pt, convert.jax_trainer_state(jt))
    jl, pl = [], []
    for i in range(3, 6):
        jl.append(float(jt.train_step(*batches[i], ts=100 + i)["loss"]))
        out = pt.train_step(*batches[i], ts=100 + i)
        assert not any(out["stats"]["new"].values())
        pl.append(out["loss"].item())
    return jt, pt, jl, pl


@pytest.mark.parametrize("step", range(3))
def test_fake_quant_trainer_losses_match_jax(quant_run, step):
    _, _, jl, pl = quant_run
    np.testing.assert_allclose(pl[step], jl[step], rtol=1e-6)


def test_fake_quant_trainer_pools_match_jax(quant_run):
    jt, pt, _, _ = quant_run
    js, ps = convert.jax_trainer_state(jt), convert.export_state(pt)
    live = np.sort(js["stores"]["sparse"][1])
    assert len(live) > 100
    np.testing.assert_allclose(ps["tables"]["sparse"][0][live],
                               js["tables"]["sparse"][0][live], atol=1e-6,
                               rtol=0)
    # the retriever really acted: the stored vectors are off the grid
    vec = ps["tables"]["sparse"][0][live][:, 1:9] / np.float32(0.25 / 128)
    assert np.abs(vec - np.round(vec)).max() > 1e-3
