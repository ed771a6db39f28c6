"""The port's CUDA kernels vs their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc, carries the `cuda` marker
and skips without them. The file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin as S


def swin_params(c, rng, device, dtype):
    def r(*shape):
        return torch.tensor(rng.normal(0, 0.05, shape).astype(np.float32), device=device)

    p = {"ln1_w": 1 + 0.1 * r(c), "ln1_b": r(c), "wqkv": r(3 * c, c), "bqkv": r(3 * c), "wout": r(c, c),
         "bout": r(c), "ln2_w": 1 + 0.1 * r(c), "ln2_b": r(c), "w1": r(4 * c, c), "b1": r(4 * c),
         "w2": r(c, 4 * c), "b2": r(c)}
    p.update({k: p[k].to(dtype) for k in S.MATRICES})
    return p


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true fp32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((8, 42, 42, 256), 2), ((8, 14, 14, 128), 2), ((1, 12, 17, 256), 2),
                                         ((2, 9, 9, 128), 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [True, False])  # False: the exact mode of the train path
def test_kernel_matches_plain(cuda, shape, heads, dtype, fast):
    """fp32: max abs error <= 1e-3 (fp32 sums in another order). bf16: max
    error <= 3e-2 of the output's largest magnitude (a bf16 rounding that
    lands one ulp off grows through the next product)."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=cuda).to(dtype)
    p = swin_params(shape[-1], rng, cuda, dtype)
    before = S.swin_block_cuda.launches
    y = S.swin_block(x, p, heads, fast=fast)
    torch.cuda.synchronize()
    assert S.swin_block_cuda.launches == before + 1
    assert y.shape == x.shape and y.dtype == dtype
    ref = S.swin_block(x, p, heads, fast=fast, impl="plain").float()
    err = (y.float() - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-3
    else:
        assert err <= 3e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_kernel_reads_a_channels_last_view(cuda):
    """The model hands the kernel the NHWC view of a channels_last NCHW tensor."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(0, 1, (2, 256, 20, 20)).astype(np.float32), device=cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    p = swin_params(256, rng, cuda, torch.float32)
    y = S.swin_block(x.permute(0, 2, 3, 1), p, 2)
    ref = S.swin_block(x.permute(0, 2, 3, 1), p, 2, impl="plain")
    assert (y - ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_kernel_raises_on_unsupported_shape(cuda):
    rng = np.random.default_rng(2)
    x = torch.zeros(1, 7, 7, 96 + 4, device=cuda)
    with pytest.raises(ValueError):
        S.swin_block(x, swin_params(100, rng, cuda, torch.float32), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((2, 40, 40, 256), 2), ((2, 20, 20, 256), 2), ((1, 12, 17, 128), 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain(cuda, shape, heads, dtype):
    """dx and the 12 grads of K3 vs swin_block_bwd_plain, each within
    tol * its largest magnitude: fp32 1e-4 (fp32 sums in another order),
    bf16 3e-2 (a bf16 rounding one ulp off grows through the next product).
    40x40 and 20x20 pad to 42x42 and 21x21: pad tokens act as keys and values."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=cuda).to(dtype)
    g = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=cuda).to(dtype)
    p = swin_params(shape[-1], rng, cuda, torch.float32)
    before = S.swin_block_bwd_cuda.launches
    dx, grads = S.swin_block_bwd(x, g, p, heads)
    torch.cuda.synchronize()
    assert S.swin_block_bwd_cuda.launches == before + 1
    rdx, rgrads = S.swin_block_bwd(x, g, p, heads, impl="plain")
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert dx.dtype == dtype and dx.shape == x.shape
    pairs = [("dx", dx, rdx)] + [(k, grads[k], rgrads[k]) for k in S.PKEYS]
    for name, got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item(), (name, err)


@pytest.mark.cuda
def test_train_function_runs_both_kernels(cuda):
    """The autograd Function launches K1 (exact mode) forward and K3 backward."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(0, 1, (2, 14, 14, 128)).astype(np.float32), device=cuda).requires_grad_()
    p = {k: v.requires_grad_() for k, v in swin_params(128, rng, cuda, torch.float32).items()}
    f0, b0 = S.swin_block_cuda.launches, S.swin_block_bwd_cuda.launches
    S.swin_block_train(x, p, 2).square().sum().backward()
    assert (S.swin_block_cuda.launches, S.swin_block_bwd_cuda.launches) == (f0 + 1, b0 + 1)
    assert all(v.grad is not None and v.grad.dtype == torch.float32 for v in p.values())


def tal_inputs(b, g, nc, imgsz, device, seed):
    """Predictions and GTs like tests/test_tal_kernel.py, plus an empty image
    and a duplicated GT."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.anchors import make_anchors

    shapes = [(imgsz // s, imgsz // s) for s in (8, 16, 32)]
    anc, st = make_anchors(shapes, (8, 16, 32))
    a = anc.shape[0]
    rng = np.random.default_rng(seed)
    scores = rng.random((b, a, nc)).astype(np.float32)
    cxy, wh = rng.uniform(10, imgsz - 10, (b, a, 2)), rng.uniform(4, imgsz / 2, (b, a, 2))
    pboxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    glab = rng.integers(0, nc, (b, g, 1)).astype(np.int32)
    gcxy, gwh = rng.uniform(12, imgsz - 12, (b, g, 2)), rng.uniform(8, imgsz / 2, (b, g, 2))
    gbox = np.concatenate([gcxy - gwh / 2, gcxy + gwh / 2], -1).astype(np.float32)
    gmask = (rng.random((b, g, 1)) < 0.7).astype(np.float32)
    gbox[0], gmask[0] = 0, 0
    if b > 1 and g > 3:
        gbox[1, 3], glab[1, 3] = gbox[1, 2], glab[1, 2]
    gbox = gbox * gmask
    t = lambda v: torch.tensor(v, device=device)  # noqa: E731
    return t(scores), t(pboxes), (anc * st).to(device), t(glab), t(gbox), t(gmask)


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,nc,imgsz", [(16, 128, 1, 640), (4, 32, 80, 640), (3, 12, 3, 128), (2, 1200, 1, 320)])
def test_tal_kernel_matches_plain(cuda, b, g, nc, imgsz):
    """K2 vs the plain assigner on the card: fg, gt index and labels exactly
    equal; boxes within 1e-4 absolute; scores within 1e-4 relative. Any G,
    1200 included (4 x max_gt 300 after mosaic)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    args = tal_inputs(b, g, nc, imgsz, cuda, seed=g)
    before = tal_assign_cuda.launches
    got = task_aligned_assign(*args, topk=10, num_classes=nc)
    torch.cuda.synchronize()
    assert tal_assign_cuda.launches == before + 1
    ref = task_aligned_assign(*args, topk=10, num_classes=nc, impl="plain")
    assert torch.equal(got.fg_mask, ref.fg_mask)
    assert torch.equal(got.target_gt_idx, ref.target_gt_idx)
    assert torch.equal(got.target_labels, ref.target_labels)
    assert (got.target_bboxes - ref.target_bboxes).abs().max().item() <= 1e-4
    torch.testing.assert_close(got.target_scores, ref.target_scores, rtol=1e-4, atol=1e-6)
    assert got.fg_mask.any()


@pytest.mark.cuda
def test_tal_kernel_rejects_other_alpha_beta(cuda):
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    with pytest.raises(ValueError, match="alpha"):
        task_aligned_assign(*tal_inputs(2, 4, 1, 128, cuda, 0), beta=4.0)


def int8_quant(x, p, heads):
    """Per-channel int8 weights from the fp32 matrices and activation scales
    from x, as ops/quant.py builds them."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8

    q = {}
    for k in S8.QKEYS:
        w = p[S8.QWEIGHTS[k]].float()
        ws = w.abs().amax(1).clamp(min=1e-12) / 127
        q.update({f"{k}_w_int8": torch.clamp(torch.round(w / ws[:, None]), -127, 127).to(torch.int8),
                  f"{k}_w_scale": ws})
    am = S8.swin_gemm_absmax(x, p, heads)
    q.update({f"{k}_x_scale": am[k] / 127 for k in S8.QKEYS})
    q["x_in_scale"] = x.float().abs().amax() / 127
    q["y_out_scale"] = S.swin_block(x, p, heads, impl="plain").float().abs().amax() / 127
    return q


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((8, 40, 40, 256), 2), ((2, 20, 17, 256), 2), ((1, 12, 9, 128), 1)])
@pytest.mark.parametrize("mode", ["int8_io", "bf16_io", "fp32_io", "sm16_int8_io", "sm16_bf16_io"])
def test_int8_kernel_matches_plain(cuda, shape, heads, mode):
    """K4 (and K4v's bf16 softmax, sm16) vs swin_block_int8_plain. The
    integer sums are exact; fp32 sums in another order may move a value
    across a quantization boundary, which the later products carry: int8
    output within 3 levels and at most 1 % of it off, float output within
    3e-2 of its largest magnitude. 40x40, 20x17 and 12x9 pad to whole windows."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8

    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=cuda)
    p = swin_params(shape[-1], rng, cuda, torch.float32)
    q = int8_quant(x, p, heads)
    io8, sm16 = mode.endswith("int8_io"), mode.startswith("sm16")
    if io8:
        xin = S8.q8(x, q["x_in_scale"]).to(torch.int8)
    else:
        xin = x.to(torch.float32 if mode == "fp32_io" else torch.bfloat16)
    before = S8.swin_block_int8_cuda.launches
    y = S8.swin_block_int8(xin, p, q, heads, in8=io8, out8=io8, sm16=sm16)
    torch.cuda.synchronize()
    assert S8.swin_block_int8_cuda.launches == before + 1
    ref = S8.swin_block_int8(xin, p, q, heads, in8=io8, out8=io8, sm16=sm16, impl="plain")
    assert y.dtype == ref.dtype and y.shape == x.shape
    d = (y.float() - ref.float()).abs()
    if io8:
        assert d.max().item() <= 3 and (d > 0).float().mean().item() <= 1e-2
    else:
        assert d.max().item() <= 3e-2 * ref.float().abs().max().item()


@pytest.mark.cuda
def test_int8_model_runs_the_int8_kernel_and_int_mm_is_exact(cuda):
    """A quantized scale-n graph with one-head SwinBlocks launches K4 twice
    per forward and K1 twice per calibration batch; the int8 product of the
    convs is exact at the stem's K=27 and at fewer than 17 rows."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import quant as Q
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8

    for m, k, n in ((5, 27, 16), (4096, 288, 64)):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=cuda)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=cuda)
        assert torch.equal(Q.int_mm(a, w), (a.double() @ w.double().t()).int())
    d = yaml_model_load("yolov8n-cbam-swin.yaml")
    for row in d["backbone"] + d["head"]:
        if row[2] == "SwinBlock":
            row[3] = [256, 1]
    y = YOLO(d, device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32).fuse()
    frames = np.random.default_rng(0).integers(0, 256, (2, 1, 128, 128, 3), dtype=np.uint8)
    f0, k0 = S.swin_block_cuda.launches, S8.swin_block_int8_cuda.launches
    quantize_model(y.model, list(frames))
    assert (S.swin_block_cuda.launches - f0, S8.swin_block_int8_cuda.launches - k0) == (4, 0)
    res = y.predict(frames[0, 0], imgsz=128, conf=0.001)
    assert S8.swin_block_int8_cuda.launches - k0 == 2 and np.isfinite(res[0].boxes.data).all()
