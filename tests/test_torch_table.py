"""The port's table (monolith_tpu_torch/embedding/table.py) against the JAX
package's: the packed pool's row math to rtol 1e-6 (f32), new-row init by
distribution (another PRNG than JAX's), and the structure-of-arrays state,
`assign_rows` and the host accessors exactly, f32 and bf16 pools."""

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


# ----------------------------------------------------------------------
# the structure-of-arrays state, assign_rows and the host accessors
# ----------------------------------------------------------------------

def _jnp_dtype(name):
    return {"f32": jnp.float32, "bf16": jnp.bfloat16}[name]


def _torch_dtype(name):
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_on_a_params_state_matches_jax(seed):
    """The serving replica's pool: -1 and rows beyond the pool read zeros,
    the result is f32, exactly the JAX package's."""
    jspec, pspec = _specs()
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=(CAP, pspec.dim)).astype(np.float32)
    rows = rng.integers(-1, CAP + 40, size=203).astype(np.int32)
    rows[:3] = [-1, CAP, CAP - 1]
    ref = np.asarray(jtable.lookup(
        jspec, {"params": jnp.asarray(pool), "slots": []}, jnp.asarray(rows)))
    out = ptable.lookup(pspec, {"params": torch.from_numpy(pool), "slots": []},
                        torch.from_numpy(rows))
    assert out.dtype == torch.float32 and out.shape == (203, pspec.dim)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy()[:2], 0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["packed", "params"])
def test_assign_rows_matches_jax(kind, dtype):
    """Values land in the params columns of the valid rows only; a packed
    state keeps its slot columns; the port writes in place."""
    jspec = JaxDeepFMTask(capacity_per_shard=CAP,
                          table_dtype=_jnp_dtype(dtype)).tables()[0]
    pspec = DeepFMTask(capacity_per_shard=CAP,
                       table_dtype=_torch_dtype(dtype)).tables()[0]
    rng = np.random.default_rng(7)
    rows = rng.permutation(CAP)[:50].astype(np.int32)
    rows[::7] = -1
    rows[1] = CAP + 3
    values = rng.normal(size=(50, pspec.dim)).astype(np.float32)
    if kind == "packed":
        base = rng.normal(size=(CAP, 128)).astype(np.float32)
        jstate = {"data": jnp.asarray(base).astype(_jnp_dtype(dtype))}
        pstate = {"data": torch.from_numpy(base).to(_torch_dtype(dtype))}
        key = "data"
    else:
        base = rng.normal(size=(CAP, pspec.dim)).astype(np.float32)
        jstate = {"params": jnp.asarray(base).astype(_jnp_dtype(dtype)),
                  "slots": []}
        pstate = {"params": torch.from_numpy(base).to(_torch_dtype(dtype)),
                  "slots": []}
        key = "params"
    ref = jtable.assign_rows(jspec, jstate, jnp.asarray(rows),
                             jnp.asarray(values))
    before = pstate[key]
    out = ptable.assign_rows(pspec, pstate, torch.from_numpy(rows),
                             torch.from_numpy(values))
    assert out[key] is before                  # in place
    np.testing.assert_array_equal(
        out[key].float().numpy(),
        np.asarray(ref[key].astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_host_accessors_match_jax(dtype):
    jspec = JaxDeepFMTask(capacity_per_shard=CAP,
                          table_dtype=_jnp_dtype(dtype)).tables()[0]
    pspec = DeepFMTask(capacity_per_shard=CAP,
                       table_dtype=_torch_dtype(dtype)).tables()[0]
    base = np.random.default_rng(8).normal(size=(40, 128)).astype(np.float32)
    jstate = {"data": np.asarray(jnp.asarray(base).astype(_jnp_dtype(dtype)))}
    pstate = {"data": torch.from_numpy(base).to(_torch_dtype(dtype))}
    ref_p, out_p = jtable.params_np(jspec, jstate), ptable.params_np(pspec, pstate)
    assert out_p.dtype == np.float32
    np.testing.assert_array_equal(out_p, ref_p)
    ref_s, out_s = (jtable.slot_items_np(jspec, jstate),
                    ptable.slot_items_np(pspec, pstate))
    assert [k for k, _ in out_s] == [k for k, _ in ref_s] == ["seg1/norm"]
    for (_, a), (_, b) in zip(out_s, ref_s):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # a serving pool (params only) reads the same way
    soa = {"params": pstate["data"][:, :pspec.dim].contiguous(), "slots": []}
    np.testing.assert_array_equal(ptable.params_np(pspec, soa), ref_p)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_slots", [True, False],
                         ids=["slots", "no_slots"])
@pytest.mark.parametrize("h", [0, 37, CAP])
def test_state_from_np_matches_jax(h, with_slots, dtype):
    """A live prefix of h rows: the port pads to capacity on the device
    (params zero, slots at their init value) where the JAX package's caller
    pads on the host; the states are equal. A missing slot starts at its
    init value."""
    jspec = JaxDeepFMTask(capacity_per_shard=CAP, accumulator_init=0.3,
                          table_dtype=_jnp_dtype(dtype)).tables()[0]
    pspec = DeepFMTask(capacity_per_shard=CAP, accumulator_init=0.3,
                       table_dtype=_torch_dtype(dtype)).tables()[0]
    rng = np.random.default_rng(h)
    pool = rng.normal(size=(h, pspec.dim)).astype(np.float32)
    norm = rng.uniform(0.1, 2.0, size=(h, 16)).astype(np.float32)
    full_pool = np.zeros((CAP, pspec.dim), np.float32)
    full_pool[:h] = pool
    full_norm = np.full((CAP, 16), 0.3, np.float32)
    full_norm[:h] = norm
    slots, jslots = (({"seg1/norm": norm}, {"seg1/norm": full_norm[None]})
                     if with_slots else ({}, {}))
    ref = jtable.state_from_np(jspec, full_pool[None], jslots, packed=True)
    out = ptable.state_from_np(pspec, pool, slots, "cpu")
    assert out["data"].dtype == _torch_dtype(dtype)
    np.testing.assert_array_equal(
        out["data"].float().numpy(),
        np.asarray(ref["data"].astype(jnp.float32))[0])


def test_state_from_np_refuses_more_rows_than_capacity():
    _, pspec = _specs()
    with pytest.raises(ValueError, match="capacity_per_shard"):
        ptable.state_from_np(pspec, np.zeros((CAP + 1, pspec.dim), np.float32),
                             {}, "cpu")
