"""The port's SwinBlock forward vs the JAX package's.

swin_block_plain (the plain version of the CUDA kernel, which the CPU runs)
is held to the JAX eager reference and to the Pallas kernel in interpret
mode on the same numpy inputs. The kernel itself is held to the plain
version on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from improving_yolov8_cbam_swinblock_tpu.ops.pallas.swin_kernel import fused_swin_block, swin_block_reference
from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin as S

jax.config.update("jax_platforms", "cpu")


def jax_params(c, rng):
    def r(*shape):
        return rng.normal(0, 0.05, shape).astype(np.float32)

    return {
        "ln1_scale": np.ones(c, np.float32) + r(c) * 0.1, "ln1_bias": r(c),
        "wqkv": r(c, 3 * c), "bqkv": r(3 * c), "wout": r(c, c), "bout": r(c),
        "ln2_scale": np.ones(c, np.float32) + r(c) * 0.1, "ln2_bias": r(c),
        "w1": r(c, 4 * c), "b1": r(4 * c), "w2": r(4 * c, c), "b2": r(c),
    }


def torch_params(p, device="cpu"):
    """JAX (in, out) layout -> the port's PyTorch (out, in) layout."""
    t = {
        "ln1_w": p["ln1_scale"], "ln1_b": p["ln1_bias"], "ln2_w": p["ln2_scale"], "ln2_b": p["ln2_bias"],
        "wqkv": p["wqkv"].T, "bqkv": p["bqkv"], "wout": p["wout"].T, "bout": p["bout"],
        "w1": p["w1"].T, "b1": p["b1"], "w2": p["w2"].T, "b2": p["b2"],
    }
    return {k: torch.tensor(np.ascontiguousarray(v), device=device) for k, v in t.items()}


def jax_padded_reference(x, p, heads):
    """The JAX SwinBlock's pad -> block -> crop around swin_block_reference."""
    b, h, w, c = x.shape
    ph, pw = (7 - h % 7) % 7, (7 - w % 7) % 7
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, ph), (0, pw), (0, 0)))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref = jax.jit(swin_block_reference, static_argnames=("num_heads", "window_size"))
    return np.asarray(ref(xp, jp, num_heads=heads, window_size=7))[:, :h, :w]


@pytest.mark.parametrize("shape,heads", [((2, 14, 21, 128), 2), ((1, 7, 14, 256), 4), ((1, 12, 10, 64), 2)])
def test_plain_matches_jax_reference_fp32(shape, heads):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, shape).astype(np.float32)
    p = jax_params(shape[-1], rng)
    ref = jax_padded_reference(x, p, heads)
    out = S.swin_block_plain(torch.from_numpy(x), torch_params(p), heads, 7, fast=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape,heads", [((2, 14, 21, 128), 2), ((1, 7, 14, 256), 4)])
def test_plain_matches_pallas_kernel_fp32(shape, heads):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, shape).astype(np.float32)
    p = jax_params(shape[-1], rng)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_swin_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                          num_heads=heads, window_size=7))
    out = S.swin_block_plain(torch.from_numpy(x), torch_params(p), heads, 7, fast=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_plain_matches_pallas_kernel_bf16_fast():
    """bf16 with fast=True: the kernel's bf16 LN1 affine and bf16 tanh GELU.
    Tolerance 2e-2: both sides round at the same places, but in another
    order of summation, so a value may land one bf16 ulp (2^-8 relative) off,
    and a flip before a product grows by the product's fan-in."""
    rng = np.random.default_rng(2)
    shape, heads = (1, 14, 14, 128), 2
    x = rng.normal(0, 1, shape).astype(np.float32)
    p = jax_params(shape[-1], rng)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_swin_block(xb, {k: jnp.asarray(v) for k, v in p.items()},
                                          num_heads=heads, window_size=7, fast=True).astype(jnp.float32))
    tp = torch_params(p)
    tp.update({k: tp[k].to(torch.bfloat16) for k in S.MATRICES})
    xt = torch.tensor(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    out = S.swin_block_plain(xt, tp, heads, 7, fast=True).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2)


def test_fast_changes_only_bf16():
    """In fp32 fast=True and fast=False are the same function; in bf16 they differ."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (1, 7, 7, 64)).astype(np.float32))
    p = torch_params(jax_params(64, rng))
    assert torch.equal(S.swin_block_plain(x, p, 2, 7, fast=True), S.swin_block_plain(x, p, 2, 7, fast=False))
    xb = x.to(torch.bfloat16)
    assert not torch.equal(S.swin_block_plain(xb, p, 2, 7, fast=True), S.swin_block_plain(xb, p, 2, 7, fast=False))


def test_dispatch_on_cpu_runs_plain_and_never_the_kernel():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (1, 9, 8, 64)).astype(np.float32))
    p = torch_params(jax_params(64, rng))
    before = S.swin_block_cuda.launches
    assert torch.equal(S.swin_block(x, p, 2), S.swin_block_plain(x, p, 2))
    assert S.swin_block_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        S.swin_block_cuda(x, p, 2)
    for impl in ("cuda", "triton"):
        with pytest.raises(ValueError, match="impl"):
            S.swin_block(x, p, 2, impl=impl)


@pytest.mark.parametrize("c,heads,ws,dtype", [
    (100, 2, 7, torch.float32),  # C not a multiple of 32
    (256, 2, 8, torch.float32),  # window other than 7
    (128, 2, 7, torch.float16),  # dtype the kernel lacks
    (1024, 2, 7, torch.float32),  # shared memory beyond the block limit
    (96, 4, 7, torch.bfloat16),  # head dim 24: the tensor-core tiles take multiples of 16
    (1024, 2, 7, torch.bfloat16),  # even the wide bf16 layout needs more shared memory than a block may use
])
def test_kernel_rejects_unsupported(c, heads, ws, dtype):
    with pytest.raises(ValueError):
        S.check_supported(c, heads, ws, dtype)


@pytest.mark.parametrize("c,heads", [(256, 2), (128, 2), (128, 4), (64, 2), (96, 2), (384, 4)])
def test_kernel_supports_flagship_widths(c, heads):
    S.check_supported(c, heads, 7, torch.float32)
    S.check_supported(c, heads, 7, torch.bfloat16)


@pytest.mark.parametrize("c", [256, 384, 512, 640, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_every_swin_width_of_both_graphs(c, dtype):
    """The flagship builds 2-head SwinBlocks at C 256 (s), 384 (m), 512 (l),
    640 (x); the YOLO11 graph at 256 (s), 512 (m, l), 768 (x): the forward
    and the backward kernel take each, within a block's shared memory. From
    C=384 the forward takes its wide layout."""
    S.check_supported(c, 2, 7, dtype)
    S.check_bwd_supported(c, 2, 7, dtype)
    assert S.fwd_smem_bytes(c, 2, dtype) <= S.MAX_SMEM and S.bwd_smem_bytes(c, 2, dtype) <= S.MAX_SMEM
    assert S.fwd_is_wide(c, 2, dtype) == (c >= 384)
