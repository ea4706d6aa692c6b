"""K1/K2 (row gather / row scatter) of the PyTorch port against the JAX
package.

On the CPU the port's wrappers run their plain versions; the JAX reference
is table.gather_packed / table.scatter_packed, whose CPU path is the XLA
gather/scatter with the Pallas kernels' semantics (tests/test_table.py
holds the two equal on a TPU). Copies are exact, so every comparison is
bit for bit. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.embedding import table as jtable
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu_torch import build, ops
from monolith_tpu_torch.ops import scatter as pscatter

torch.set_num_threads(1)

CAP, P = 256, 128


def _spec():
    return JaxDeepFMTask(capacity_per_shard=CAP).tables()[0]


def _case(seed, n):
    """Pool [CAP, P], unique rows [n] with ~1/4 -1 entries, values [n, P]."""
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=(CAP, P)).astype(np.float32)
    rows = rng.choice(CAP, size=n, replace=False).astype(np.int32)
    rows[rng.random(n) < 0.25] = -1
    values = rng.normal(size=(n, P)).astype(np.float32)
    return pool, rows, values


@pytest.mark.parametrize("n", [1, 7, 33, 100, 256])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_gather_rows_matches_jax(n, fn):
    pool, rows, _ = _case(n, n)
    ref = np.asarray(jtable.gather_packed(_spec(), {"data": jnp.asarray(pool)},
                                          jnp.asarray(rows)))
    gather = (pscatter.gather_rows_plain if fn == "plain"
              else pscatter.gather_rows)
    out = gather(torch.from_numpy(pool), torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert (out[rows < 0] == 0).all()


@pytest.mark.parametrize("n", [1, 7, 33, 100, 256])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_scatter_rows_matches_jax(n, fn):
    pool, rows, values = _case(100 + n, n)
    ref = np.asarray(jtable.scatter_packed(
        _spec(), {"data": jnp.asarray(pool)}, jnp.asarray(rows),
        jnp.asarray(values))["data"])
    scatter = (pscatter.scatter_rows_plain if fn == "plain"
               else pscatter.scatter_rows)
    pool_t = torch.from_numpy(pool.copy())
    out = scatter(pool_t, torch.from_numpy(rows), torch.from_numpy(values))
    assert out.data_ptr() == pool_t.data_ptr()  # written in place
    np.testing.assert_array_equal(pool_t.numpy().view(np.int32),
                                  ref.view(np.int32))


def test_out_of_range_rows_read_zeros_and_drop():
    pool, _, values = _case(5, 4)
    rows = np.array([CAP, -1, 3, CAP + 7], np.int32)
    out = pscatter.gather_rows(torch.from_numpy(pool), torch.from_numpy(rows))
    np.testing.assert_array_equal(out.numpy()[[0, 1, 3]], 0)
    np.testing.assert_array_equal(out.numpy()[2], pool[3])
    pool_t = torch.from_numpy(pool.copy())
    pscatter.scatter_rows(pool_t, torch.from_numpy(rows),
                          torch.from_numpy(values))
    expect = pool.copy()
    expect[3] = values[2]
    np.testing.assert_array_equal(pool_t.numpy(), expect)


def test_cpu_wrappers_count_no_launches():
    ops.reset_launch_counts()
    pool, rows, values = _case(9, 16)
    pscatter.gather_rows(torch.from_numpy(pool), torch.from_numpy(rows))
    pscatter.scatter_rows(torch.from_numpy(pool), torch.from_numpy(rows),
                          torch.from_numpy(values))
    assert pscatter.gather_rows.launches == 0
    assert pscatter.scatter_rows.launches == 0


def test_non_cpu_tensor_raises_instead_of_falling_back():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches the kernel or raises."""
    pool = torch.empty((CAP, P), device="meta")
    rows = torch.empty((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pscatter.gather_rows(pool, rows)
    with pytest.raises(ValueError, match="CUDA"):
        pscatter.scatter_rows(pool, rows, torch.empty((8, P), device="meta"))


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_kernel_library()


def test_scatter_rejects_mismatched_values():
    pool, rows, values = _case(11, 8)
    with pytest.raises(ValueError, match="dtype"):
        pscatter.scatter_rows(torch.from_numpy(pool), torch.from_numpy(rows),
                              torch.from_numpy(values).double())
    with pytest.raises(ValueError, match="match"):
        pscatter.scatter_rows(torch.from_numpy(pool), torch.from_numpy(rows),
                              torch.from_numpy(values[:, :64].copy()))
