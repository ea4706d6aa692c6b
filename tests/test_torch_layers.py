"""The port's layer zoo (layers/{activations,agru,cross,feature_cross,
feature_seq,feature_trans,multi_task}.py, ops/interactions.py and the MLP's
new options) against the JAX package's layers, on the CPU.

Each case mirrors one of tests/test_layers.py's (TestCross, TestTrans,
TestSeq, TestMultiTask; SNR is not ported) at its sizes: the same inputs,
made from a seed with numpy, go through the flax layer and the port's,
whose parameters are the flax `init`'s carried by convert.py (and read
back out as the flax tree exactly: every leaf crosses by name, a Dense
kernel transposed). Forwards are held to f32 tolerance, rtol 1e-5 / atol
1e-6 (sums in another order); the cases with inputs to differentiate also
hold the gradient of a random projection of the outputs with respect to
those inputs to that tolerance. Parameter init is held by distribution:
each initializer's draws against flax's on the same shape (mean, standard
deviation, bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu import layers as jl
from monolith_tpu.layers import activations as jacts
from monolith_tpu.ops import interactions as jops
from monolith_tpu_torch import convert
from monolith_tpu_torch import layers as pl
from monolith_tpu_torch.layers import activations as pacts
from monolith_tpu_torch.layers import initializers as pinit
from monolith_tpu_torch.ops import interactions as pops

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
KEY = jax.random.PRNGKey(0)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for e in x for leaf in _leaves(e)]
    return [x]


def _torch(x):
    if isinstance(x, tuple):
        return tuple(_torch(e) for e in x)
    return torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x


def _load(module, params):
    """The flax params, carried by convert.py, into the port module; they
    read back out as the flax tree exactly. Leaves other than a Dense
    kernel (allint_kernel, cin_w_i, kernel_i, U/V/gate, nas_logits,
    pos_emb, ...) cross by name, without a transpose."""
    named = {k: torch.from_numpy(np.array(v))
             for k, v in convert._to_module_tensors(params).items()}
    assert set(named) == {n for n, _ in module.named_parameters()}
    module.load_state_dict(named)
    back = convert._flatten(convert.dense_tree(module.named_parameters()))
    want = convert._flatten(params)
    assert sorted(back) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=str(path))
    return module


# name -> () -> (flax module, inputs (numpy or tuples of numpy), port
# module, indices of the inputs to differentiate or None)
CASES = {
    "groupint_multiply": lambda: (
        jl.GroupInt(dim_size=8, interaction_type="multiply"),
        ((_normal(1, 4, 16), _normal(2, 4, 24)),),
        pl.GroupInt(dim_size=8, interaction_type="multiply"), None),
    "groupint_dot": lambda: (
        jl.GroupInt(dim_size=8, interaction_type="dot"),
        ((_normal(1, 4, 16), _normal(2, 4, 24)),),
        pl.GroupInt(dim_size=8, interaction_type="dot"), None),
    "groupint_attention": lambda: (
        jl.GroupInt(dim_size=8, use_attention=True, attention_units=(4, 1)),
        ((_normal(1, 4, 16), _normal(2, 4, 24)),),
        pl.GroupInt(dim_size=8, use_attention=True, attention_units=(4, 1)),
        (0,)),
    "allint": lambda: (
        jl.AllInt(cmp_dim=3), (_normal(3, 4, 6, 8),),
        pl.AllInt(num_fields=6, cmp_dim=3), (0,)),
    "allint_no_bias_3d": lambda: (
        jl.AllInt(cmp_dim=3, use_bias=False, flatten=False),
        (_normal(3, 4, 6, 8),),
        pl.AllInt(num_fields=6, cmp_dim=3, use_bias=False, flatten=False),
        None),
    "cdot": lambda: (
        jl.CDot(project_dim=4, compress_units=(16,)), (_normal(4, 4, 6, 8),),
        pl.CDot(num_fields=6, dim=8, project_dim=4, compress_units=(16,)),
        (0,)),
    "can": lambda: (
        jl.CAN(layer_num=2), ((_normal(5, 4, 6), _normal(6, 4, 84)),),
        pl.CAN(layer_num=2), (0,)),
    "can_seq_relu": lambda: (
        jl.CAN(layer_num=1, activation="relu", is_seq=True),
        ((_normal(5, 4, 3, 6), _normal(6, 4, 42)),),
        pl.CAN(layer_num=1, activation="relu", is_seq=True), None),
    "dcn_vector": lambda: (
        jl.DCN(dcn_type="vector", layer_num=2), (_normal(7, 4, 16),),
        pl.DCN(16, dcn_type="vector", layer_num=2), (0,)),
    "dcn_matrix": lambda: (
        jl.DCN(dcn_type="matrix", layer_num=2), (_normal(7, 4, 16),),
        pl.DCN(16, dcn_type="matrix", layer_num=2), (0,)),
    "dcn_mixed": lambda: (
        jl.DCN(dcn_type="mixed", layer_num=2, num_experts=3, low_rank=4),
        (_normal(7, 4, 16),),
        pl.DCN(16, dcn_type="mixed", layer_num=2, num_experts=3, low_rank=4),
        (0,)),
    "cin": lambda: (
        jl.CIN(layer_sizes=(6, 4)), (_normal(8, 4, 5, 8),),
        pl.CIN(num_fields=5, layer_sizes=(6, 4)), (0,)),
    "crossnet": lambda: (
        jl.CrossNet(num_layers=3), (_normal(9, 4, 24),),
        pl.CrossNet(24, num_layers=3), (0,)),
    "autoint": lambda: (
        jl.AutoInt(layer_num=2), (_normal(10, 4, 5, 8),),
        pl.AutoInt(layer_num=2), (0,)),
    "autoint_flat": lambda: (
        jl.AutoInt(layer_num=1, flatten=True), (_normal(10, 4, 5, 8),),
        pl.AutoInt(layer_num=1, flatten=True), None),
    "senet": lambda: (
        jl.SeNet(reduction_ratio=2), (_normal(11, 4, 6, 8),),
        pl.SeNet(num_fields=6, reduction_ratio=2), (0,)),
    "irazor": lambda: (
        jl.iRazor(nas_space=(0, 2, 4, 8), penalty_weight=0.1),
        (_normal(12, 4, 5, 8),),
        pl.iRazor(num_fields=5, nas_space=(0, 2, 4, 8), penalty_weight=0.1),
        (0,)),
    "din_sum": lambda: (
        jl.DIN(mode="sum"),
        (_normal(13, 4, 8), _normal(14, 4, 10, 8), _mask(4, 10)),
        pl.DIN(8, 10, mode="sum"), (0, 1)),
    "din_scale": lambda: (
        jl.DIN(mode="scale"),
        (_normal(13, 4, 8), _normal(14, 4, 10, 8), _mask(4, 10)),
        pl.DIN(8, 10, mode="scale"), (0, 1)),
    "din_hidden_decay": lambda: (
        jl.DIN(hidden_units=(16, 8, 1), decay=True),
        (_normal(13, 4, 8), _normal(14, 4, 10, 8), _mask(4, 10)),
        pl.DIN(8, 10, hidden_units=(16, 8, 1), decay=True), (0, 1)),
    "dien_dot": lambda: (
        jl.DIEN(num_units=8, att_type="dot"),
        (_normal(15, 4, 8), _normal(16, 4, 6, 8), _mask(4, 6)),
        pl.DIEN(8, 8, num_units=8, att_type="dot"), (0, 1)),
    "dien_mlp": lambda: (
        jl.DIEN(num_units=8, att_type="mlp"),
        (_normal(15, 4, 8), _normal(16, 4, 6, 8), _mask(4, 6)),
        pl.DIEN(8, 8, num_units=8, att_type="mlp"), (0, 1)),
    "dien_all_padding_rows": lambda: (
        jl.DIEN(num_units=8, att_type="dot"),
        (_normal(15, 4, 8), _normal(16, 4, 6, 8),
         _mask(4, 6) * np.array([[0], [1], [0], [1]], np.float32)),
        pl.DIEN(8, 8, num_units=8, att_type="dot"), (0, 1)),
    "dmr_u2i": lambda: (
        jl.DMR_U2I(cmp_dim=4), (_normal(17, 4, 12), _normal(18, 4, 6, 8)),
        pl.DMR_U2I(item_dim=12, seq_dim=8, seq_len=6, cmp_dim=4), (0, 1)),
    "gru": lambda: (
        jl.GRU(16), (_normal(19, 4, 6, 8), _mask(4, 6)),
        pl.GRU(8, 16), (0,)),
    "augru": lambda: (
        jl.AUGRU(16),
        (_normal(19, 4, 6, 8), np.abs(_normal(20, 4, 6)) / 6),
        pl.AUGRU(8, 16), (0, 1)),
    "mmoe": lambda: (
        jl.MMoE(num_tasks=3, num_experts=4, expert_output_dims=(8,)),
        (_normal(21, 4, 16),),
        pl.MMoE(16, num_tasks=3, num_experts=4, expert_output_dims=(8,)),
        (0,)),
    "mmoe_topk": lambda: (
        jl.MMoE(num_tasks=2, num_experts=4, expert_output_dims=(8,),
                gate_type="topk", top_k=2),
        (_normal(21, 4, 16),),
        pl.MMoE(16, num_tasks=2, num_experts=4, expert_output_dims=(8,),
                gate_type="topk", top_k=2), (0,)),
    "mmoe_gate_input": lambda: (
        jl.MMoE(num_tasks=2, num_experts=3, expert_output_dims=(8, 4)),
        (_normal(21, 4, 16), _normal(22, 4, 5)),
        pl.MMoE(16, num_tasks=2, num_experts=3, expert_output_dims=(8, 4),
                gate_input_dim=5), (0, 1)),
}


def _mask(b, t, seed=23):
    """Real steps first, then padding; every row has at least one."""
    lens = np.random.default_rng(seed).integers(1, t + 1, size=b)
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def _run(name):
    jmod, args, pmod, diff = CASES[name]()
    params = jax.jit(jmod.init)(KEY, *args).get("params", {})
    _load(pmod, params)
    targs = [_torch(a) for a in args]
    for i in diff or ():
        for leaf in _leaves(targs[i]):
            leaf.requires_grad_(True)
    jout = jax.jit(jmod.apply)({"params": params}, *args)
    pout = pmod(*targs)
    return jmod, args, params, diff, targs, _leaves(jout), _leaves(pout)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_flax(name):
    jmod, args, params, diff, targs, jouts, pouts = _run(name)
    assert len(jouts) == len(pouts)
    for j, p in zip(jouts, pouts):
        assert tuple(p.shape) == tuple(np.shape(j))
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   rtol=RTOL, atol=ATOL)
    if diff is None:
        return
    cots = [_normal(100 + k, *np.shape(j)) for k, j in enumerate(jouts)]

    def projected(*dargs):
        full = list(args)
        for i, a in zip(diff, dargs):
            full[i] = a
        out = _leaves(jmod.apply({"params": params}, *full))
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))

    grad = jax.jit(jax.grad(projected, argnums=tuple(range(len(diff)))))
    jgrads = jax.tree.leaves(grad(*[args[i] for i in diff]))
    proj = sum((p * torch.from_numpy(c)).sum() for p, c in zip(pouts, cots))
    inputs = [leaf for i in diff for leaf in _leaves(targs[i])]
    pgrads = torch.autograd.grad(proj, inputs)
    assert len(jgrads) == len(pgrads)
    for j, p in zip(jgrads, pgrads):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def test_a_flax_leaf_named_weight_has_no_counterpart():
    with pytest.raises(ValueError, match="no port counterpart"):
        convert._to_module_tensors({"m": {"weight": np.zeros(2)}})


def test_groupint_dot_of_ones_is_the_dim():
    out = pl.GroupInt(dim_size=8, interaction_type="dot")(
        (torch.ones(4, 16), torch.ones(4, 24)))
    assert out.shape == (4, 6)
    torch.testing.assert_close(out, torch.full((4, 6), 8.0))


def test_din_mask_zeroes_padding():
    out = pl.DIN(4, 3)(torch.ones(2, 4), torch.ones(2, 3, 4),
                       torch.zeros(2, 3))
    torch.testing.assert_close(out, torch.zeros(2, 4))


def test_dien_masked_steps_carry_the_state():
    """A masked step gets a softmax score of 0 (logit -1e9), and the AUGRU's
    update gate is scaled by it: the state after a padded tail equals the
    state after the real steps alone."""
    torch.manual_seed(0)
    dien = pl.DIEN(8, 8, num_units=8, generator=torch.Generator()
                   .manual_seed(1))
    q, k = torch.randn(3, 8), torch.randn(3, 6, 8)
    mask = torch.ones(3, 6)
    mask[:, 4:] = 0
    outs, _ = dien.interest_gru(k, mask)
    scores = torch.softmax(torch.where(
        mask > 0, torch.einsum("bu,btu->bt", dien.query_proj(q), outs),
        torch.tensor(-1e9)), dim=1)
    assert torch.all(scores[:, 4:] == 0)
    torch.testing.assert_close(dien(q, k, mask),
                               dien.evolution(outs[:, :4], scores[:, :4]))


def _tied_mmoe(package, num_tasks=2, b=8):
    """An MMoE with top_k 2 whose gates' logits are (1, 1, 1, 0) on every
    row: a kernel of zeros and a bias of (1, 1, 1, 0)."""
    x = _normal(24, b, 16)
    jmod = jl.MMoE(num_tasks=num_tasks, num_experts=4,
                   expert_output_dims=(8,), gate_type="topk", top_k=2)
    params = jax.tree.map(np.array, jax.jit(jmod.init)(KEY, x)["params"])
    for t in range(num_tasks):
        params[f"gate_{t}"]["kernel"][:] = 0.0
        params[f"gate_{t}"]["bias"][:] = [1.0, 1.0, 1.0, 0.0]
    if package == "jax":
        return jax.jit(jmod.apply)({"params": params}, x), params, x
    pmod = _load(pl.MMoE(16, num_tasks=num_tasks, num_experts=4,
                         expert_output_dims=(8,), gate_type="topk", top_k=2),
                 params)
    return pmod(torch.from_numpy(x)), pmod, x


def test_mmoe_topk_keeps_tied_logits():
    """The threshold is the 2nd largest logit, 1, and every logit >= it is
    kept: three experts share each gate equally, where torch.topk's indices
    would keep two."""
    (outs, aux), pmod, x = _tied_mmoe("port")
    (jouts, jaux), _, _ = _tied_mmoe("jax")
    xt = torch.from_numpy(x)
    mean3 = sum(getattr(pmod, f"expert_{i}")(xt) for i in range(3)) / 3
    for o, jo in zip(outs, jouts):
        torch.testing.assert_close(o, mean3, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=RTOL)


def test_mmoe_aux_loss_is_the_population_cv2():
    """Importance B/3 (1, 1, 1, 0) per task: the population variance over
    the squared mean is 1/3 (the unbiased variance would give 4/9), summed
    over 2 tasks."""
    (_, aux), _, _ = _tied_mmoe("port")
    (_, jaux), _, _ = _tied_mmoe("jax")
    np.testing.assert_allclose(aux.item(), 2.0 / 3.0, rtol=1e-6)
    np.testing.assert_allclose(float(jaux), 2.0 / 3.0, rtol=1e-6)


def test_mmoe_softmax_gates_have_no_aux_loss():
    _, _, _, _, _, jouts, pouts = _run("mmoe")
    assert float(pouts[-1]) == float(jouts[-1]) == 0.0


def test_dcn_dropout_is_refused_until_the_training_flag():
    """DCN(use_dropout=True) is no longer refused: in eval mode it is the
    cross network without dropout, equal to flax's training=False; in
    train mode each layer keeps a value with probability keep_prob (within
    4 sigma over 512 x 16 values) and scales it by 1 / keep_prob."""
    from monolith_tpu_torch.layers.draws import set_generator
    x = _normal(60, 512, 16)
    jmod = jl.DCN(layer_num=2, use_dropout=True, keep_prob=0.7)
    params = jmod.init(KEY, x)["params"]
    pmod = _load(pl.DCN(16, layer_num=2, use_dropout=True, keep_prob=0.7),
                 params).eval()
    want = jmod.apply({"params": params}, x, training=False)
    np.testing.assert_allclose(pmod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)
    one = _load(pl.DCN(16, layer_num=1, use_dropout=True, keep_prob=0.7),
                {k: v for k, v in params.items() if k.endswith("_0")})
    full = one.eval()(torch.from_numpy(x)).detach()
    set_generator(one, torch.Generator().manual_seed(0))
    out = one.train()(torch.from_numpy(x)).detach()
    kept = out != 0
    sigma = np.sqrt(0.7 * 0.3 / out.numel())
    assert abs(kept.float().mean().item() - 0.7) < 4 * sigma
    assert torch.equal(out[kept], full[kept] / 0.7)


# ----------------------------------------------------------------------
# ops, activations, the MLP's options
# ----------------------------------------------------------------------

@pytest.mark.parametrize("int_type", ["multiply", "dot"])
def test_ffm_interaction_matches_jax(int_type):
    left, right = _normal(30, 5, 3 * 4), _normal(31, 5, 2 * 4)
    ref = jops.ffm_interaction(left, right, 4, int_type)
    out = pops.ffm_interaction(torch.from_numpy(left),
                               torch.from_numpy(right), 4, int_type)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="unknown int_type"):
        pops.ffm_interaction(torch.from_numpy(left), torch.from_numpy(right),
                             4, "sum")


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_matches_jax(self_interaction):
    embs = _normal(32, 5, 6, 4)
    ref = jops.dot_interaction(embs, self_interaction=self_interaction)
    out = pops.dot_interaction(torch.from_numpy(embs),
                               self_interaction=self_interaction)
    assert out.shape == (5, 21 if self_interaction else 15)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", sorted(jacts._REGISTRY))
def test_activation_matches_flax(name):
    x = _normal(33, 4, 7) * 3
    ref = jacts.get(name)(x)
    out = pacts.get(name)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["prelu", "dice"])
def test_parametric_activation_matches_flax(name):
    x = _normal(34, 6, 5)
    jmod = jacts.get(name)
    params = jax.tree.map(np.array, jmod.init(KEY, x)["params"])
    params["alpha"][:] = _normal(35, 5)      # flax inits to a constant
    ref = jmod.apply({"params": params}, x)
    out = _load(pacts.get(name, dim=5), params)(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_activation_registry_errors():
    assert pacts.get(None)(torch.ones(2)).tolist() == [1.0, 1.0]
    assert pacts.get(torch.tanh) is torch.tanh
    with pytest.raises(ValueError, match="unknown activation"):
        pacts.get("nope")
    with pytest.raises(ValueError, match="width of its inputs"):
        pacts.get("prelu")
    assert pacts.get("prelu", 3).alpha.tolist() == [0.25] * 3


@pytest.mark.parametrize("kw", [dict(activate_last=True),
                                dict(use_bias=False),
                                dict(activation="tanh", activate_last=True)],
                         ids=["activate_last", "no_bias", "tanh"])
def test_mlp_options_match_flax(kw):
    from monolith_tpu.layers.mlp import MLP as JaxMLP
    x = _normal(36, 8, 12)
    jkw = dict(kw)
    if "activation" in jkw:
        jkw["activation"] = jacts.get(jkw["activation"])
    jmod = JaxMLP(output_dims=(6, 3), **jkw)
    params = jmod.init(KEY, x)["params"]
    ref = jmod.apply({"params": params}, x)
    out = _load(pl.MLP(12, (6, 3), **kw), params)(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# init, by distribution
# ----------------------------------------------------------------------

INITS = {"lecun_normal": jax.nn.initializers.lecun_normal(),
         "glorot_normal": jax.nn.initializers.glorot_normal(),
         "glorot_uniform": jax.nn.initializers.glorot_uniform()}


@pytest.mark.parametrize("name", sorted(INITS))
@pytest.mark.parametrize("shape", [(300, 200), (48, 32), (4, 80, 60)])
def test_initializer_matches_flax_in_distribution(name, shape):
    ref = np.asarray(INITS[name](KEY, shape, jnp.float32))
    out = getattr(pinit, name)(shape, torch.Generator().manual_seed(0))
    out = out.numpy()
    assert out.shape == ref.shape
    n = ref.size
    # the sample standard deviation's own spread is ~std / sqrt(2n)
    np.testing.assert_allclose(out.std(), ref.std(),
                               rtol=6 / np.sqrt(2 * n))
    assert abs(out.mean() - ref.mean()) < 6 * ref.std() / np.sqrt(n)
    assert np.abs(out).max() <= np.abs(ref).max() * 1.02
    assert np.abs(out).max() >= np.abs(ref).max() * 0.8


def test_dense_layers_draw_lecun_normal_and_zero_bias():
    """A bare Dense (CrossNet's, the GRU's, the gates') is flax's
    nn.Dense: lecun-normal kernel, zero bias; not nn.Linear's init."""
    layer = pinit.dense(400, 300, torch.Generator().manual_seed(0))
    w = layer.weight.detach().numpy()
    assert w.shape == (300, 400) and not layer.bias.detach().any()
    std = np.sqrt(1 / 400)
    np.testing.assert_allclose(w.std(), std, rtol=0.02)
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
    lin = torch.nn.Linear(400, 300)
    assert abs(lin.weight.detach().numpy().std() - std) > 0.1 * std
