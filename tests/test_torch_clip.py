"""monolith_tpu_torch.ops.clip against monolith_tpu.ops.clip on the CPU.

The same leaves, made from a seed with numpy, go through both
`clip_by_global_norm`s: f32 and bf16 leaves, a norm below and above the
clip, a caller's norm, an empty tree. The norm to rtol 1e-6 (f32 sums in
another order); f32 leaves to rtol 1e-6; bf16 leaves bit for bit or one
bf16 ulp apart (the scale may differ in its last f32 bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.ops import clip as jclip
from monolith_tpu_torch.ops import clip

torch.set_num_threads(1)


def _trees(seed, bf16):
    rng = np.random.default_rng(seed)
    leaves = {"deep.dense_0.weight": rng.normal(size=(16, 8)),
              "deep.dense_0.bias": rng.normal(size=(16,)),
              "deep.dense_1.weight": rng.normal(size=(1, 16))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    jt = {k: jnp.asarray(v) for k, v in leaves.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
    if bf16:
        jt = {k: v.astype(jnp.bfloat16) for k, v in jt.items()}
        pt = {k: v.to(torch.bfloat16) for k, v in pt.items()}
    return jt, pt


def _f32(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") \
        else x.float().numpy()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("clip_norm", [0.5, 1e3], ids=["above", "below"])
def test_clip_matches_jax(bf16, clip_norm):
    jt, pt = _trees(3, bf16)
    jout, jnorm = jclip.clip_by_global_norm(jt, clip_norm)
    pout, pnorm = clip.clip_by_global_norm(pt, clip_norm)
    np.testing.assert_allclose(pnorm.numpy(), np.asarray(jnorm), rtol=1e-6)
    assert (float(pnorm) > clip_norm) == (clip_norm == 0.5)
    assert set(pout) == set(jout)
    for k in jout:
        assert pout[k].dtype == pt[k].dtype
        ref, out = _f32(jout[k]), _f32(pout[k])
        if bf16:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
            assert np.all(np.abs(out - ref) <= ulp), k
        else:
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    if clip_norm == 1e3:  # below the clip: scale is exactly 1
        for k in pt:
            assert torch.equal(pout[k], pt[k])


def test_global_norm_matches_jax():
    jt, pt = _trees(4, False)
    np.testing.assert_allclose(clip.global_norm(pt).numpy(),
                               np.asarray(jclip.global_norm(jt)), rtol=1e-6)


def test_use_norm_replaces_the_trees_own():
    jt, pt = _trees(5, False)
    jout, jnorm = jclip.clip_by_global_norm(jt, 1.0, use_norm=jnp.float32(4.0))
    pout, pnorm = clip.clip_by_global_norm(pt, 1.0,
                                           use_norm=torch.tensor(4.0))
    assert float(pnorm) == float(jnorm) == 4.0
    for k in jout:
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-6)
    pout2, _ = clip.clip_by_global_norm(pt, 1.0, use_norm=4.0)
    for k in pout:
        assert torch.equal(pout2[k], pout[k])


def test_empty_tree():
    jout, jnorm = jclip.clip_by_global_norm({}, 1.0)
    pout, pnorm = clip.clip_by_global_norm({}, 1.0)
    assert pout == {} and jout == {}
    assert float(pnorm) == float(jnorm) == 0.0
