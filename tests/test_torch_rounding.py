"""K3 (stochastic rounding f32 -> bf16) of the PyTorch port against the JAX
package.

The port's arithmetic (`round_with_noise`) is held bit for bit against the
JAX package's portable version, `_stochastic_round_bf16_jnp`, on the same
noise: the draw that function makes from its key (rounding.py:27) is
repeated here and handed to the port. The port's Philox4x32-10 is held to
Random123's known-answer vectors. Its noise differs from JAX's by design,
so the rounding as a whole is held by distribution, as the JAX package's
own tests hold it (tests/test_parity_extras.py), and through the port's
table functions. The CUDA kernel runs on the card (tests/test_torch_cuda.py,
chip_smoke.py), where it is held bit for bit against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.ops.rounding import _stochastic_round_bf16_jnp
from monolith_tpu_torch import build
from monolith_tpu_torch.embedding import initializers, optimizers
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.embedding.spec import TableSegment, TableSpec
from monolith_tpu_torch.ops import rounding

torch.set_num_threads(1)

F32_MAX = np.finfo(np.float32).max


def _values(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=n).astype(np.float32)
    if kind == "negative":
        return -np.abs(rng.normal(size=n) * 1e3).astype(np.float32)
    if kind == "tiny":
        return (rng.normal(size=n) * 1e-30).astype(np.float32)
    if kind == "bf16_exact":
        return np.array(jnp.asarray(rng.normal(size=n), jnp.bfloat16)
                        .astype(jnp.float32))
    # zeros, signed zeros, the largest finite f32, infinities
    special = np.array([0.0, -0.0, F32_MAX, -F32_MAX, np.inf, -np.inf,
                        1.0, -1.0], dtype=np.float32)
    return np.resize(special, n)


@pytest.mark.parametrize("kind", ["normal", "negative", "tiny", "bf16_exact",
                                  "special"])
@pytest.mark.parametrize("seed", [0, 1])
def test_round_with_noise_matches_jax_bitwise(kind, seed):
    x = _values(kind, 4099, seed)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(_stochastic_round_bf16_jnp(jnp.asarray(x), key)
                     .view(jnp.uint16))
    noise = np.asarray(jax.random.randint(key, x.shape, 0, 1 << 16,
                                          dtype=jnp.uint32))
    out = rounding.round_with_noise(torch.from_numpy(x),
                                    torch.from_numpy(noise.astype(np.int64)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy()
                                  .view(np.uint16), ref)


@pytest.mark.parametrize("counter,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, expect):
    out = rounding.philox4x32_10([torch.tensor([c]) for c in counter], key)
    assert tuple(int(w) for w in out) == expect


def test_noise_follows_the_documented_mapping():
    """Element i takes the high 16 bits of word i % 4 of Philox at counter
    (i // 4, 0, 0, 0), key (seed mod 2^32, seed >> 32)."""
    seed = (7 << 32) | 11
    noise = rounding.philox_noise16(seed, 10)
    for i in range(10):
        words = rounding.philox4x32_10(
            [torch.tensor([i // 4]), torch.tensor([0]), torch.tensor([0]),
             torch.tensor([0])], (11, 7))
        assert int(noise[i]) == int(words[i % 4]) >> 16
    assert int(noise.min()) >= 0 and int(noise.max()) < 1 << 16


@pytest.mark.parametrize("value,lo,hi", [(1.0 + 2 ** -9, 0.2, 0.3),
                                         (1.0 + 2 ** -8, 0.45, 0.55)])
def test_unbiased_rounding(value, lo, hi):
    x = torch.full((4096,), value)
    vals = rounding.stochastic_round_bf16(x, 3).float().numpy()
    assert lo < (vals > 1.0).mean() < hi
    assert abs(vals.mean() - value) < 2 ** -10


def test_outputs_bracket_the_input():
    x = torch.from_numpy(_values("normal", 10_000, 5) * 100)
    out = rounding.stochastic_round_bf16(x, 9).float()
    down = rounding.round_with_noise(x, torch.zeros(x.numel(),
                                                    dtype=torch.int64)).float()
    up = rounding.round_with_noise(
        x, torch.full((x.numel(),), 0xFFFF, dtype=torch.int64)).float()
    assert torch.all((out == down) | (out == up))
    assert torch.all(torch.minimum(down, up) <= x)
    assert torch.all(x <= torch.maximum(down, up))


def test_same_seed_same_output_other_seed_other_output():
    x = torch.from_numpy(_values("normal", 2048, 6))
    launches = rounding.stochastic_round_bf16.launches
    a = rounding.stochastic_round_bf16(x, 42)
    b = rounding.stochastic_round_bf16(x, 42)
    c = rounding.stochastic_round_bf16(x, 43)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert not torch.equal(a.view(torch.int16), c.view(torch.int16))
    # the CPU runs the plain version, which launches nothing
    assert rounding.stochastic_round_bf16.launches == launches


@pytest.mark.parametrize("shape", [(0,), (3,), (5, 7), (2, 3, 128)])
def test_any_shape(shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    out = rounding.stochastic_round_bf16(x, 1)
    assert out.shape == x.shape and out.dtype == torch.bfloat16


def test_wrapper_checks_its_inputs():
    with pytest.raises(ValueError, match="float32"):
        rounding.stochastic_round_bf16(torch.zeros(4, dtype=torch.float64), 0)
    with pytest.raises(ValueError, match="seed"):
        rounding.stochastic_round_bf16(torch.zeros(4), -1)
    with pytest.raises(ValueError, match="CUDA"):
        rounding.stochastic_round_bf16(torch.empty(4, device="meta"), 0)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_kernel_library("rounding")


def _spec(stochastic):
    seg = TableSegment(dim=4, optimizer=optimizers.SGD(learning_rate=1.0),
                       initializer=initializers.Zeros())
    return TableSpec("t", 64, (seg,), dtype=torch.bfloat16,
                     stochastic_rounding=stochastic)


def _tiny_updates(spec, steps):
    """Assign 1.0 to row 0, then apply `steps` SGD updates of 2^-10 (under
    half a bf16 ulp at 1.0), each narrowed with its own seed."""
    st = ptable.create_state(spec, "cpu")
    rows = torch.tensor([0], dtype=torch.int32)
    ptable.scatter_packed(spec, st, rows, torch.ones((1, 128)))
    for i in range(steps):
        packed = ptable.gather_packed(spec, st, rows)
        new = ptable.optimize_packed(spec, packed,
                                     torch.full((1, 4), 2.0 ** -10), i)
        ptable.scatter_packed(spec, st, rows, new, seed=i)
    return float(ptable.lookup(spec, st, rows).mean())


def test_bf16_table_with_stochastic_rounding_learns_small_updates():
    # expected drift: 200 * 2^-10 ~ 0.195
    val = _tiny_updates(_spec(True), 200)
    assert val < 0.95, f"stochastic rounding failed to accumulate: {val}"


def test_plain_bf16_stalls_on_tiny_updates():
    # control: rounding to nearest loses every update
    assert _tiny_updates(_spec(False), 50) > 0.99


def test_bf16_state_rounds_slot_init_to_nearest():
    spec = TableSpec("t", 8, (TableSegment(
        dim=4, optimizer=optimizers.Adagrad(initial_accumulator_value=0.01)),),
        dtype=torch.bfloat16)
    data = ptable.create_state(spec, "cpu")["data"]
    assert data.dtype == torch.bfloat16
    assert float(data[0, 4]) == 0.010009765625
    assert ptable.gather_packed(spec, {"data": data},
                                torch.tensor([0, -1], dtype=torch.int32)
                                ).dtype == torch.float32
