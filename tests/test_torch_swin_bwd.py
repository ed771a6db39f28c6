"""The port's differentiable SwinBlock vs the JAX package's custom_vjp.

`swin_block_train` (exact forward; on the CPU the backward is
`swin_block_bwd_plain`, the plain version of the CUDA backward kernel) is
held to JAX pad -> `fused_swin_block_ad` -> crop, the train path of the JAX
SwinBlock, with the Pallas kernels in interpret mode as
tests/test_pallas_swin.py runs them, on the same numpy inputs and cotangent.
Compared: the output, dx and the 12 parameter grads, each relative to its
largest magnitude: 1e-3 in fp32 (the tolerance of test_pallas_swin.py:86),
3e-2 in bf16 (the same roundings, with sums taken in another order: a bf16
rounding one ulp off grows through the next product). One shape pads.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from improving_yolov8_cbam_swinblock_tpu.ops.pallas.swin_kernel import fused_swin_block_ad
from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin as S
from tests.test_torch_swin import jax_params, torch_params
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

# JAX name -> (port name, JAX layout -> port layout)
NAMES = {"ln1_scale": "ln1_w", "ln1_bias": "ln1_b", "wqkv": "wqkv", "bqkv": "bqkv", "wout": "wout", "bout": "bout",
         "ln2_scale": "ln2_w", "ln2_bias": "ln2_b", "w1": "w1", "b1": "b1", "w2": "w2", "b2": "b2"}


def jax_padded_ad(x, p, cot, heads, dtype):
    """Output and grads of sum(crop(fused_swin_block_ad(pad(x))) * cot)."""
    b, h, w, c = x.shape
    ph, pw = (7 - h % 7) % 7, (7 - w % 7) % 7

    def f(xx, pp):
        y = fused_swin_block_ad(jnp.pad(xx, ((0, 0), (0, ph), (0, pw), (0, 0))), pp, heads, 7)[:, :h, :w]
        return (y.astype(jnp.float32) * cot).sum(), y

    with pltpu.force_tpu_interpret_mode():
        (_, y), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x).astype(dtype), {k: jnp.asarray(v) for k, v in p.items()})
    return np.asarray(y.astype(jnp.float32)), np.asarray(gx.astype(jnp.float32)), \
        {k: np.asarray(v) for k, v in gp.items()}


def rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,heads", [((2, 14, 21, 128), 2), ((1, 7, 14, 256), 4), ((2, 6, 10, 128), 2)])
def test_train_block_matches_jax_custom_vjp(shape, heads, dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, shape).astype(np.float32)
    p = jax_params(shape[-1], rng)
    cot = rng.normal(0, 1, shape).astype(np.float32)
    jy, jgx, jgp = jax_padded_ad(x, p, cot, heads, getattr(jnp, dtype))

    tdt = getattr(torch, dtype)
    tx = torch.tensor(x).to(tdt).requires_grad_()
    tp = {k: v.requires_grad_() for k, v in torch_params(p).items()}
    y = S.swin_block_train(tx, tp, heads)
    (y.float() * torch.tensor(cot)).sum().backward()
    assert y.dtype == tdt and tx.grad.dtype == tdt
    assert all(v.grad.dtype == torch.float32 for v in tp.values())

    tol = 1e-3 if dtype == "float32" else 3e-2
    assert rel(y.float().detach().numpy(), jy) <= tol
    assert rel(tx.grad.float().numpy(), jgx) <= tol
    for jname, tname in NAMES.items():
        ref = jgp[jname].T if jgp[jname].ndim == 2 else jgp[jname]
        assert rel(tp[tname].grad.numpy(), ref) <= tol, tname


def test_bwd_dispatch_and_pad_tokens_reach_the_weight_grads():
    """Pad tokens are keys and values of their window: at a padded shape they
    add to dWqkv / dbqkv / dln1_b. Removing the pad (the same tokens in a
    7x7 image with zero rows given a zero grad) leaves every grad the same."""
    rng = np.random.default_rng(8)
    p = torch_params(jax_params(64, rng))
    x = torch.tensor(rng.normal(0, 1, (1, 5, 6, 64)).astype(np.float32))
    g = torch.tensor(rng.normal(0, 1, (1, 5, 6, 64)).astype(np.float32))
    dx, grads = S.swin_block_bwd(x, g, p, 2)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 1, 0, 2))
    gp = torch.nn.functional.pad(g, (0, 0, 0, 1, 0, 2))
    dxp, gradsp = S.swin_block_bwd(xp, gp, p, 2)
    torch.testing.assert_close(dx, dxp[:, :5, :6])
    for k in S.PKEYS:
        torch.testing.assert_close(grads[k], gradsp[k], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        S.swin_block_bwd(x, g, p, 2, impl="cuda")
