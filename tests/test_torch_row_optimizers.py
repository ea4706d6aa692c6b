"""The port's row optimizers, learning-rate schedules and packed-row layout
against the JAX package's, on the CPU.

Every one of the 15 optimizer classes (several with their options on) takes
3 steps from the same params, slots and gradients, made from a seed with
numpy, through the JAX class's `apply` and the port's: params and every
slot to rtol 1e-6 / atol 1e-7 (atol 1e-6 for Ftrl, GroupFtrl and
GroupAdagrad, whose new params are a difference of O(1) terms: one f32 ulp
of an accumulator, 1.2e-7, shows in full in a param near zero).
`DC.stale_apply` runs with a non-zero
`stale - p`. The 3 schedules are held at steps 0, 1, warmup - 1,
decay_steps and decay_steps + 5 to rtol 1e-6, and `table._layout` gives the
same columns at the same offsets in both packages for every class.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.embedding import optimizers as jopt
from monolith_tpu.embedding import spec as jspec
from monolith_tpu.embedding import table as jtable
from monolith_tpu_torch.embedding import optimizers as popt
from monolith_tpu_torch.embedding import spec as pspec
from monolith_tpu_torch.embedding import table as ptable

torch.set_num_threads(1)

M, D = 6, 5
WD = dict(weight_decay_factor=0.05)

#: id -> (class name, kwargs, dim); every class of NAMED_OPTIMIZERS appears
CASES = {
    "sgd": ("SGD", dict(learning_rate=0.3), D),
    "adagrad": ("Adagrad", dict(initial_accumulator_value=0.2), D),
    "adagrad_wd": ("Adagrad", WD, D),
    "dynamic_wd_adagrad": ("DynamicWdAdagrad", WD, D),
    "dynamic_wd_adagrad_decoupled": (
        "DynamicWdAdagrad", dict(decouple_weight_decay=True, **WD), D),
    "adadelta": ("Adadelta", dict(epsilon=0.02, **WD), D),
    "adam": ("Adam", dict(epsilon=0.02), D),
    "adam_nesterov_wd": ("Adam", dict(use_nesterov=True, **WD), D),
    "amsgrad": ("AMSGrad", {}, D),
    "amsgrad_nesterov_wd": ("AMSGrad", dict(use_nesterov=True, **WD), D),
    "momentum": ("Momentum", WD, D),
    "momentum_nesterov": ("Momentum", dict(use_nesterov=True), D),
    "moving_average": ("MovingAverage", dict(momentum=0.8), D),
    "rmsprop": ("RMSprop", WD, D),
    "rmspropv2": ("RMSpropV2", WD, D),
    "ftrl": ("Ftrl", dict(beta=0.1), D),
    "ftrl_l1_l2": ("Ftrl", dict(l1_regularization_strength=0.4,
                                l2_regularization_strength=0.3), D),
    "group_ftrl": ("GroupFtrl", {}, D),
    "group_ftrl_l1_l2": ("GroupFtrl", dict(
        initial_accumulator_value=0.1, l1_regularization_strength=1.5,
        l2_regularization_strength=0.3), D),
    "group_adagrad": ("GroupAdagrad", dict(beta=0.1, **WD), D),
    "group_adagrad_l2": ("GroupAdagrad",
                         dict(l2_regularization_strength=30.0), D),
    "batch_softmax": ("BatchSoftmax", {}, 1),
    "dc_sgd": ("DC", dict(lambda_=0.7), D),
    "dc_adagrad": ("DC", dict(lambda_=0.7, base="Adagrad"), D),
}


def _make(mod, name, kwargs):
    kwargs = dict(kwargs)
    if isinstance(kwargs.get("base"), str):
        kwargs["base"] = getattr(mod, kwargs["base"])(learning_rate=0.2)
    return getattr(mod, name)(**kwargs)


def test_cases_cover_every_class():
    assert {c[0] for c in CASES.values()} == \
        {cls.__name__ for cls in jopt.NAMED_OPTIMIZERS.values()}
    assert {n: c.__name__ for n, c in popt.NAMED_OPTIMIZERS.items()} == \
        {n: c.__name__ for n, c in jopt.NAMED_OPTIMIZERS.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_matches_jax(case):
    name, kwargs, dim = CASES[case]
    jo, po = _make(jopt, name, kwargs), _make(popt, name, kwargs)
    assert jo.slot_spec(dim) == po.slot_spec(dim)
    assert jo.learning_rate == po.learning_rate
    rng = np.random.default_rng(sorted(CASES).index(case))
    p = rng.normal(size=(M, dim)).astype(np.float32)
    slots = {n: (init + 0.1 * np.abs(rng.normal(size=(M, k)))
                 * (not n.endswith("_power"))).astype(np.float32)
             for n, (k, init) in jo.slot_spec(dim).items()}
    jp, js = jnp.asarray(p), {n: jnp.asarray(v) for n, v in slots.items()}
    pp = torch.from_numpy(p.copy())
    ps = {n: torch.from_numpy(v.copy()) for n, v in slots.items()}
    lr = 0.25
    atol = 1e-6 if name in ("Ftrl", "GroupFtrl", "GroupAdagrad") else 1e-7
    for step in range(3, 6):
        g = rng.normal(size=(M, dim)).astype(np.float32)
        if name == "DC":
            stale = (np.asarray(jp) + 0.3 * rng.normal(size=(M, dim))
                     ).astype(np.float32)
            jp, js = jo.stale_apply(jp, js, jnp.asarray(g), jnp.float32(lr),
                                    jnp.int32(step), jnp.asarray(stale))
            pp, ps = po.stale_apply(pp, ps, torch.from_numpy(g), lr, step,
                                    torch.from_numpy(stale))
        else:
            jp, js = jo.apply(jp, js, jnp.asarray(g), jnp.float32(lr),
                              jnp.int32(step))
            pp, ps = po.apply(pp, ps, torch.from_numpy(g), lr, step)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=atol, err_msg=f"params, step {step}")
        assert set(ps) == set(js)
        for n in js:
            np.testing.assert_allclose(ps[n].numpy(), np.asarray(js[n]),
                                       rtol=1e-6, atol=atol,
                                       err_msg=f"slot {n}, step {step}")
    assert pp.dtype == torch.float32 and pp.shape == (M, dim)


def test_dc_without_stale_is_its_base():
    po = popt.DC(lambda_=0.7, base=popt.Adagrad(learning_rate=0.2))
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32))
    slots = {"norm": torch.full((M, D), 0.1)}
    a, sa = po.apply(p, slots, g, 0.2, 0)
    b, sb = po.base.apply(p, slots, g, 0.2, 0)
    assert torch.equal(a, b) and torch.equal(sa["norm"], sb["norm"])


WARMUP, DECAY = 7, 20
SCHEDULES = {
    "constant": ("Constant", dict(value=0.03)),
    "poly": ("PolynomialDecay", dict(initial_learning_rate=0.5,
                                     decay_steps=DECAY,
                                     end_learning_rate=0.01)),
    "poly_power2": ("PolynomialDecay", dict(initial_learning_rate=0.5,
                                            decay_steps=DECAY,
                                            end_learning_rate=0.01,
                                            power=2.0)),
    "poly_cycle": ("PolynomialDecay", dict(initial_learning_rate=0.5,
                                           decay_steps=DECAY,
                                           end_learning_rate=0.01,
                                           power=0.5, cycle=True)),
    "warmup_constant": ("WarmupSchedule", dict(base="constant",
                                               warmup_steps=WARMUP)),
    "warmup_poly": ("WarmupSchedule", dict(base="poly",
                                           warmup_steps=WARMUP)),
    "warmup_off": ("WarmupSchedule", dict(base="poly", warmup_steps=0)),
}


def _schedule(mod, key):
    name, kwargs = SCHEDULES[key]
    kwargs = dict(kwargs)
    if "base" in kwargs:
        kwargs["base"] = _schedule(mod, kwargs["base"])
    return getattr(mod, name)(**kwargs)


@pytest.mark.parametrize("step", [0, 1, WARMUP - 1, DECAY, DECAY + 5, 3 * DECAY])
@pytest.mark.parametrize("key", sorted(SCHEDULES))
def test_schedule_matches_jax(key, step):
    ref = float(_schedule(jspec, key)(jnp.int32(step)))
    out = _schedule(pspec, key)(step)
    assert isinstance(out, float)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_segment_learning_rate_uses_the_schedule():
    seg = pspec.TableSegment(dim=4, optimizer=popt.SGD(learning_rate=0.3),
                             lr_schedule=_schedule(pspec, "warmup_poly"))
    assert seg.learning_rate(2) == _schedule(pspec, "warmup_poly")(2)
    assert pspec.TableSegment(dim=4, optimizer=popt.SGD(learning_rate=0.3)
                              ).learning_rate(2) == 0.3


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_jax(case):
    name, kwargs, dim = CASES[case]

    def spec(smod, omod):
        segs = (smod.TableSegment(dim=3, optimizer=omod.Adagrad()),
                smod.TableSegment(dim=dim,
                                  optimizer=_make(omod, name, kwargs)),
                smod.TableSegment(dim=2, optimizer=omod.SGD()))
        return smod.TableSpec(name="t", capacity_per_shard=8, segments=segs)

    assert ptable._layout(spec(pspec, popt)) == \
        jtable._layout(spec(jspec, jopt))


def test_optimize_packed_hands_stale_rows_to_dc_segments_only():
    """A DC segment sees stale[..., off:off+dim]; an Adagrad segment beside
    it ignores `stale` (monolith_tpu/embedding/table.py:217)."""
    def spec(smod, omod):
        segs = (smod.TableSegment(dim=2, optimizer=omod.Adagrad(
                    learning_rate=0.5)),
                smod.TableSegment(dim=4, optimizer=omod.DC(
                    learning_rate=0.5, lambda_=0.5,
                    base=omod.SGD(learning_rate=0.5))))
        return smod.TableSpec(name="t", capacity_per_shard=8, segments=segs)

    rng = np.random.default_rng(1)
    latest = np.abs(rng.normal(size=(3, 128))).astype(np.float32)
    stale = np.abs(rng.normal(size=(3, 128))).astype(np.float32)
    g = rng.normal(size=(3, 6)).astype(np.float32)
    ref = jtable.optimize_packed(spec(jspec, jopt), jnp.asarray(latest),
                                 jnp.asarray(g), jnp.int32(2),
                                 stale=jnp.asarray(stale))
    out = ptable.optimize_packed(spec(pspec, popt), torch.from_numpy(latest),
                                 torch.from_numpy(g), 2,
                                 stale=torch.from_numpy(stale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    plain = ptable.optimize_packed(spec(pspec, popt),
                                   torch.from_numpy(latest),
                                   torch.from_numpy(g), 2)
    assert torch.equal(plain[:, :2], out[:, :2])        # Adagrad: no stale
    assert not torch.equal(plain[:, 2:6], out[:, 2:6])  # DC: compensated
