"""Each block of the port vs its flax counterpart, on carried-across weights.

The flax block's variables come from its abstract init (shapes only, no
compile): uniform kernels and random norms, biases and BN statistics, all
drawn with numpy; the variables go through the port's weight bridge
into the torch block (strict load), and both run the same numpy input in
fp32. Tolerance 2e-4: the same fp32 math summed in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.nn import modules as JM
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as TM
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import state_dict_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
TOL = 2e-4


def randomize(variables, rng):
    """numpy copy of the variables with random norms, biases and BN statistics."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            a = np.asarray(v, np.float32)
            if k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                a = rng.normal(0, 0.1, a.shape).astype(np.float32)
            out[k] = a
        return out

    return walk(variables)


def japply(jm, v, x):
    """The flax block's eval forward under one jax.jit (op by op, each primitive compiles on its own)."""
    return jax.jit(jm.apply)(v, x)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def carry(jmod, tmod, *args, seed=0):
    """The flax block's variables from its abstract init on args (no
    compile): kernels uniform with the JAX package's conv init variance
    1 / (3 fan_in), then randomize(); carried into tmod; returns the variables."""
    rng = np.random.default_rng(seed)

    def leaf(sd):
        if sd.ndim < 2:
            return np.zeros(sd.shape, np.float32)
        bound = np.sqrt(1.0 / np.prod(sd.shape[:-1]))
        return rng.uniform(-bound, bound, sd.shape).astype(np.float32)

    v = randomize(jax.tree.map(leaf, jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(seed), *args))), rng)
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    tmod.eval()
    return v


@pytest.mark.parametrize("c1,c2,k,s", [(3, 16, 3, 2), (16, 24, 1, 1), (8, 8, 3, 1)])
def test_conv(c1, c2, k, s):
    x = np.random.default_rng(1).normal(0, 1, (2, 12, 12, c1)).astype(np.float32)
    jm, tm = JM.Conv(c2, k, s), TM.Conv(c1, c2, k, s)
    v = carry(jm, tm, jnp.asarray(x))
    ref = np.asarray(japply(jm, v, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tm(nchw(x))), ref, rtol=TOL, atol=TOL)
        tm.fuse()
        np.testing.assert_allclose(nhwc(tm(nchw(x))), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,shortcut", [(1, True), (2, False)])
def test_c2f(n, shortcut):
    x = np.random.default_rng(2).normal(0, 1, (2, 10, 10, 16)).astype(np.float32)
    jm, tm = JM.C2f(32, n, shortcut), TM.C2f(16, 32, n, shortcut)
    v = carry(jm, tm, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(japply(jm, v, jnp.asarray(x))), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [5, 7])
def test_sppf(k):
    x = np.random.default_rng(3).normal(0, 1, (2, 6, 6, 32)).astype(np.float32)
    jm, tm = JM.SPPF(32, k), TM.SPPF(32, 32, k)
    v = carry(jm, tm, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(japply(jm, v, jnp.asarray(x))), rtol=TOL, atol=TOL)


def test_cbam():
    x = np.random.default_rng(4).normal(0, 1, (2, 5, 7, 64)).astype(np.float32)
    jm, tm = JM.CBAM(), TM.CBAM(64)
    assert tm.ca.shared_MLP[0].out_channels == 64 // 16
    v = carry(jm, tm, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(japply(jm, v, jnp.asarray(x))), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hw,c,heads", [((14, 14), 64, 2), ((12, 12), 64, 2), ((6, 10), 128, 4)])
def test_swin_block(hw, c, heads):
    """(12, 12) is the flagship's P4 map at 96 px: padded to 14 x 14 inside."""
    x = np.random.default_rng(5).normal(0, 1, (2, *hw, c)).astype(np.float32)
    jm, tm = JM.SwinBlock(num_heads=heads), TM.SwinBlock(c, heads)
    v = carry(jm, tm, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(japply(jm, v, jnp.asarray(x))), rtol=TOL, atol=TOL)


def test_swin_block_refuses_training():
    """Training mode no longer refuses: it runs the differentiable block in
    exact mode (fast=False), and its grads reach every parameter."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block

    tm = TM.SwinBlock(64, 2).train()
    x = torch.randn(1, 64, 7, 7, generator=torch.Generator().manual_seed(0))
    y = tm(x)
    ref = swin_block(x.permute(0, 2, 3, 1), tm.kernel_params(), 2, fast=False).permute(0, 3, 1, 2)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    y.square().sum().backward()
    assert all(p.grad is not None for p in tm.parameters())


def test_concat_and_upsample():
    rng = np.random.default_rng(6)
    a, b = rng.normal(0, 1, (1, 4, 4, 3)).astype(np.float32), rng.normal(0, 1, (1, 4, 4, 5)).astype(np.float32)
    ref = np.asarray(JM.Concat().apply({}, [jnp.asarray(a), jnp.asarray(b)]))
    np.testing.assert_array_equal(nhwc(TM.Concat()([nchw(a), nchw(b)])), ref)
    ref = np.asarray(JM.Upsample(2).apply({}, jnp.asarray(a)))
    np.testing.assert_array_equal(nhwc(TM.Upsample(2)(nchw(a))), ref)


@pytest.mark.parametrize("nc", [1, 3])
def test_detect(nc):
    rng = np.random.default_rng(7)
    ch, strides = (16, 32, 64), (8, 16, 32)
    xs = [rng.normal(0, 1, (2, 8 // (2 ** i), 8 // (2 ** i), c)).astype(np.float32) for i, c in enumerate(ch)]
    jm, tm = JM.Detect(nc=nc, ch=ch, strides=strides), TM.Detect(nc, ch, strides)
    v = carry(jm, tm, [jnp.asarray(x) for x in xs])
    ref, ref_feats = japply(jm, v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        out, feats = tm([nchw(x) for x in xs])
    assert out.shape == (2, 4 + nc, 64 + 16 + 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL * 10)
    for f, rf in zip(feats, ref_feats):
        np.testing.assert_allclose(nhwc(f), np.asarray(rf), rtol=TOL, atol=TOL)


def test_detect_bias_prior():
    tm = TM.Detect(1, (16, 32, 64), (8, 16, 32))
    tm.bias_init()
    assert torch.all(tm.cv2[0][-1].bias == 1.0)
    assert abs(tm.cv3[2][-1].bias.item() - np.log(5 / 1 / (640 / 32) ** 2)) < 1e-6
