"""The port's packed table (monolith_tpu_torch/embedding/table.py) against
the JAX package's. f32 throughout; row math to rtol 1e-6. New-row init
draws from another PRNG than JAX's and is held by distribution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.embedding import table as jtable
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.models.deepfm import DeepFMTask

torch.set_num_threads(1)

CAP = 512


def _specs(**kw):
    return (JaxDeepFMTask(capacity_per_shard=CAP, **kw).tables()[0],
            DeepFMTask(capacity_per_shard=CAP, **kw).tables()[0])


def _rows_with_state(seed, n):
    """Packed rows [n, P] with positive Adagrad norm columns."""
    jspec, _ = _specs()
    _, padded, slots = jtable._layout(jspec)
    rng = np.random.default_rng(seed)
    packed = rng.normal(size=(n, padded)).astype(np.float32)
    for (off, k, _) in slots.values():
        packed[:, off:off + k] = rng.uniform(0.01, 2.0, size=(n, k))
    grads = rng.normal(size=(n, jspec.dim)).astype(np.float32) * 0.1
    return packed, grads


@pytest.mark.parametrize("dim", [4, 16, 60, 120])
def test_layout_matches_jax(dim):
    jspec, pspec = _specs(embedding_dim=dim)
    assert ptable._layout(pspec) == jtable._layout(jspec)


@pytest.mark.parametrize("accumulator_init", [0.01, 0.0, 0.5])
def test_create_state_matches_jax(accumulator_init):
    jspec, pspec = _specs(accumulator_init=accumulator_init)
    ref = np.asarray(jtable.create_state(jspec)["data"])
    out = ptable.create_state(pspec, "cpu")["data"].numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed,step", [(0, 0), (1, 5), (2, 100)])
def test_optimize_packed_matches_jax(seed, step):
    """SGD bias segment + Adagrad vector segment, padded columns kept."""
    jspec, pspec = _specs(bias_lr=0.5, vector_lr=0.3)
    packed, grads = _rows_with_state(seed, 64)
    ref = np.asarray(jtable.optimize_packed(jspec, jnp.asarray(packed),
                                            jnp.asarray(grads),
                                            jnp.int32(step)))
    out = ptable.optimize_packed(pspec, torch.from_numpy(packed),
                                 torch.from_numpy(grads), step).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookup_matches_jax(seed):
    jspec, pspec = _specs()
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(CAP, 128)).astype(np.float32)
    rows = rng.integers(-1, CAP, size=97).astype(np.int32)
    ref = np.asarray(jtable.lookup(jspec, {"data": jnp.asarray(data)},
                                   jnp.asarray(rows)))
    out = ptable.lookup(pspec, {"data": torch.from_numpy(data)},
                        torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    assert out.shape == (97, pspec.dim)


@pytest.mark.parametrize("init_scale", [0.3, 0.05])
def test_init_packed_distribution(init_scale):
    """Bounds [-s, s], mean within 3 sigma of 0, zeros in the bias and pad
    columns, Adagrad norm columns at their init value."""
    _, pspec = _specs(init_scale=init_scale, accumulator_init=0.01)
    n = 4096
    gen = torch.Generator().manual_seed(3)
    rows = ptable.init_packed(pspec, gen, n, "cpu").numpy()
    width, padded, slots = ptable._layout(pspec)
    assert rows.shape == (n, padded)
    vec = rows[:, 1:pspec.dim]
    assert vec.min() >= -init_scale and vec.max() <= init_scale
    sigma_mean = init_scale / np.sqrt(3.0) / np.sqrt(vec.size)
    assert abs(vec.mean()) < 3 * sigma_mean
    assert vec.std() > 0.5 * init_scale / np.sqrt(3.0)
    np.testing.assert_array_equal(rows[:, 0], 0.0)          # bias segment
    np.testing.assert_array_equal(rows[:, width:], 0.0)      # pad
    (off, k, init_value), = slots.values()
    np.testing.assert_array_equal(rows[:, off:off + k], np.float32(init_value))


def test_params_np_and_scatter_roundtrip():
    jspec, pspec = _specs()
    state = ptable.create_state(pspec, "cpu")
    packed, _ = _rows_with_state(4, 8)
    rows = torch.tensor([3, -1, 0, 7, 100, -1, 511, 42], dtype=torch.int32)
    ptable.scatter_packed(pspec, state, rows, torch.from_numpy(packed))
    got = ptable.gather_packed(pspec, state, rows).numpy()
    valid = rows.numpy() >= 0
    np.testing.assert_array_equal(got[valid], packed[valid])
    np.testing.assert_array_equal(got[~valid], 0.0)
    params = ptable.params_np(pspec, state)
    assert params.shape == (CAP, pspec.dim)
    np.testing.assert_array_equal(params[3], packed[0, :pspec.dim])
