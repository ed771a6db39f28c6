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
                                         ((2, 9, 9, 128), 4), ((2, 21, 21, 64), 2), ((4, 20, 20, 128), 4),
                                         ((2, 14, 14, 384), 2), ((2, 12, 17, 512), 2), ((2, 14, 14, 640), 2),
                                         ((2, 14, 14, 768), 2), ((1, 12, 17, 512), 4),
                                         ((2, 34, 34, 256), 2), ((2, 28, 28, 256), 2)])  # the TTA grids at 640 px
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [True, False])  # False: the exact mode of the train path
def test_kernel_matches_plain(cuda, shape, heads, dtype, fast):
    """fp32: max abs error <= 1e-3 (fp32 sums in another order). bf16: max
    error <= 3e-2 of the output's largest magnitude (a bf16 rounding that
    lands one ulp off grows through the next product). Head dims 32 and 64
    and C=64 exercise the padded tensor-core tiles of the bf16 kernel; C
    from 384 runs the wide layout (head dims 192 to 384 in 64-wide slices)."""
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
@pytest.mark.parametrize("c,heads", [(256, 2), (128, 2), (128, 4), (64, 2), (96, 2), (384, 4), (512, 4), (384, 2),
                                     (512, 2), (640, 2), (768, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smem_copies_match_library(cuda, c, heads, dtype):
    """fwd_smem_bytes and bwd_smem_bytes, the checks' copies for the CPU,
    give the bytes the built kernels ask for."""
    assert S._lib().swin_block_fwd_smem_bytes(S._DTYPES[dtype], c, heads) == S.fwd_smem_bytes(c, heads, dtype)
    assert S._bwd_lib().swin_block_bwd_smem_bytes(S._DTYPES[dtype], c, heads) == S.bwd_smem_bytes(c, heads, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(256, 2), (128, 1), (128, 2), (128, 4), (64, 2), (192, 2), (384, 4), (512, 4),
                                     (512, 2), (640, 2), (768, 2)])
@pytest.mark.parametrize("cbf", [True, False])
def test_int8_smem_copy_matches_library(cuda, c, heads, cbf):
    """smem_bytes of ops/swin_int8.py, the check's copy for the CPU, gives
    the bytes the built K4 asks for, in either compute dtype."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8

    assert S8._lib().swin_block_int8_smem_bytes(c, heads, int(cbf)) == S8.smem_bytes(c, heads, cbf)


@pytest.mark.cuda
def test_kernel_raises_on_unsupported_shape(cuda):
    rng = np.random.default_rng(2)
    x = torch.zeros(1, 7, 7, 96 + 4, device=cuda)
    with pytest.raises(ValueError):
        S.swin_block(x, swin_params(100, rng, cuda, torch.float32), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((2, 40, 40, 256), 2), ((2, 20, 20, 256), 2), ((1, 12, 17, 128), 4),
                                         ((2, 21, 21, 64), 2), ((4, 20, 20, 128), 4), ((2, 14, 14, 384), 2),
                                         ((2, 14, 14, 512), 2), ((1, 12, 17, 640), 2), ((2, 14, 14, 768), 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain(cuda, shape, heads, dtype):
    """dx and the 12 grads of K3 vs swin_block_bwd_plain, each within
    tol * its largest magnitude: fp32 1e-4 (fp32 sums in another order),
    bf16 3e-2 (a bf16 rounding one ulp off grows through the next product).
    40x40 and 20x20 pad to 42x42 and 21x21: pad tokens act as keys and values.
    Head dims above 128 run the attention in 128-wide slices."""
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
    and a duplicated GT; imgsz is one side or (h, w). Returns the six inputs
    and the anchor grid."""
    args, grid = tal_numpy(b, g, nc, imgsz, seed)
    return to_device(args, device), grid


def to_device(args, device):
    return tuple(torch.tensor(v, device=device) for v in args)


def tal_grid(imgsz, strides=(8, 16, 32)):
    """The anchor points (A, 2) in pixels and the grid (h, w, stride) per level."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.anchors import make_anchors

    h, w = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    grid = [(h // s, w // s, s) for s in strides]
    anc, st = make_anchors([(gh, gw) for gh, gw, _ in grid], strides)
    return (anc * st).numpy(), grid


def tal_numpy(b, g, nc, imgsz, seed, strides=(8, 16, 32)):
    anc, grid = tal_grid(imgsz, strides)
    h, w = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    size = np.array([w, h], np.float64)
    a = anc.shape[0]
    rng = np.random.default_rng(seed)
    scores = rng.random((b, a, nc)).astype(np.float32)
    cxy, wh = rng.uniform(10, size - 10, (b, a, 2)), rng.uniform(4, size / 2, (b, a, 2))
    pboxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    glab = rng.integers(0, nc, (b, g, 1)).astype(np.int32)
    gcxy, gwh = rng.uniform(12, size - 12, (b, g, 2)), rng.uniform(8, size / 2, (b, g, 2))
    gbox = np.concatenate([gcxy - gwh / 2, gcxy + gwh / 2], -1).astype(np.float32)
    gmask = (rng.random((b, g, 1)) < 0.7).astype(np.float32)
    gbox[0], gmask[0] = 0, 0
    if b > 1 and g > 3:
        gbox[1, 3], glab[1, 3] = gbox[1, 2], glab[1, 2]
    gbox = gbox * gmask
    return (scores, pboxes, anc, glab, gbox, gmask), grid


def tal_edge_case(name):
    """Inputs (numpy), grid and topk of one case that the kernel's candidate
    rectangles, zero fill and claim resolution make delicate, at 128 px
    (A = 336) with nc = 3:
      edges      GT edges exactly on anchor centres of each level, and one
                 ulp inside and outside them
      image      a GT covering the whole image, one partly outside it
      degenerate a zero-width and a zero-height GT
      zero_fill  every prediction far from the top-left GTs, so that fewer
                 than K anchors have align > 0 and the plain top-k's zero
                 fill picks the lowest anchor indices, candidates of a GT
                 over the top-left corner; a GT with 3 positive anchors
      zero_multi two GTs over the top-left corner, every prediction far
                 away: the zero-fill anchors are claimed twice with overlap
                 0 and go to GT 0, which does not contain them (image 0)
                 or is masked out (image 1)"""
    anc, grid = tal_grid(128)
    a, g, b, nc = anc.shape[0], 6, 2, 3
    rng = np.random.default_rng(7)
    scores = rng.random((b, a, nc)).astype(np.float32)
    cxy, wh = rng.uniform(10, 118, (b, a, 2)), rng.uniform(4, 64, (b, a, 2))
    pboxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    glab = rng.integers(0, nc, (b, g, 1)).astype(np.int32)
    gmask = np.ones((b, g, 1), np.float32)
    gbox = np.tile(np.array([[30, 34, 90, 100]], np.float32), (b, g, 1))
    up = lambda v: np.nextafter(np.float32(v), np.float32(np.inf))  # noqa: E731
    down = lambda v: np.nextafter(np.float32(v), np.float32(-np.inf))  # noqa: E731
    far = np.array([104, 104, 124, 124], np.float32)  # predictions in the bottom-right corner
    if name == "edges":  # centres: 4 + 8i (level 0), 8 + 16i (level 1), 16 + 32i (level 2)
        for i, (x1, y1, x2, y2) in enumerate([(20, 28, 68, 92), (24, 40, 88, 104), (16, 48, 80, 112)]):
            gbox[:, i] = (x1, y1, x2, y2)
            gbox[0, i + 3] = (up(x1), down(y1), up(x2), down(y2))
            gbox[1, i + 3] = (down(x1), up(y1), down(x2), up(y2))
    elif name == "image":
        gbox[:, 0] = (0, 0, 128, 128)
        gbox[:, 1] = (-50, -30, 60, 200)
        gbox[1, 2] = (100, -40, 300, 60)
    elif name == "degenerate":
        gbox[:, 0] = (36, 20, 36, 90)
        gbox[:, 1] = (10, 44, 120, 44)
        gbox[1, 2] = (0, 0, 0, 0)
    elif name == "zero_fill":
        pboxes[:] = far
        gbox[:, 0] = (0, 0, 40, 40)
        gbox[:, 1] = (44, 44, 96, 96)
        for k in (5, 9, 12):  # three level-0 anchors inside GT 1 predict a box near it
            row, col = (44 + 4 * k) // 8, (44 + 4 * k) // 8
            pboxes[:, row * 16 + col] = (40 + k, 42, 94, 98 - k)
        gbox[1, 2:] = (0, 0, 20, 64)
    elif name == "zero_multi":
        pboxes[:] = far
        gbox[:, 0] = (60, 60, 100, 100)
        gbox[:, 1] = (0, 0, 40, 40)
        gbox[:, 2] = (0, 0, 48, 30)
        gmask[1, 0] = 0
        gbox[:, 3:] = (0, 0, 24, 24)
    else:
        raise ValueError(name)
    return (scores, pboxes, anc, glab, gbox, gmask), grid, 10


TAL_CASES = [
    # (b, g, nc, imgsz, topk[, strides]): the train path, G = 4 * max_gt after mosaic
    (16, 128, 1, 640, 10), (4, 32, 80, 640, 10), (3, 12, 3, 128, 10), (2, 1200, 1, 320, 10),
    (2, 1, 1, 128, 10), (3, 12, 3, 128, 1), (3, 40, 80, 256, 16), (2, 16, 2, (480, 640), 10),
    # YOLOv10's one-to-one assignment at the train path's shape
    (16, 128, 1, 640, 1),
    # the four-level grids of the P2 graphs (A = 34,000 at 640 px) and the P6 graphs (A = 8,500)
    (16, 128, 1, 640, 10, (4, 8, 16, 32)), (16, 128, 1, 640, 10, (8, 16, 32, 64)),
    "edges", "image", "degenerate", "zero_fill", "zero_multi",
]


def tal_case(case):
    """(numpy inputs, grid, nc, topk) of a TAL_CASES entry."""
    if isinstance(case, str):
        args, grid, topk = tal_edge_case(case)
        return args, grid, args[0].shape[2], topk
    b, g, nc, imgsz, topk, *levels = case
    args, grid = tal_numpy(b, g, nc, imgsz, seed=g, strides=levels[0] if levels else (8, 16, 32))
    return args, grid, nc, topk


def assert_tal_equal(got, ref):
    assert torch.equal(got.fg_mask, ref.fg_mask)
    assert torch.equal(got.target_gt_idx, ref.target_gt_idx)
    assert torch.equal(got.target_labels, ref.target_labels)
    assert (got.target_bboxes - ref.target_bboxes).abs().max().item() <= 1e-4
    torch.testing.assert_close(got.target_scores, ref.target_scores, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TAL_CASES, ids=str)
def test_tal_kernel_matches_plain(cuda, case):
    """K2 vs the plain assigner on the card, in one launch: fg, gt index and
    labels exactly equal; boxes within 1e-4 absolute; scores within 1e-4
    relative. Any G, 1200 included (4 x max_gt 300 after mosaic), G = 1,
    topk 1 and 16, nc 80, a 640x480 rect batch, and the edge cases of
    tal_edge_case."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    args, grid, nc, topk = tal_case(case)
    args = to_device(args, cuda)
    before = tal_assign_cuda.launches
    got = task_aligned_assign(*args, topk=topk, num_classes=nc, grid=grid)
    torch.cuda.synchronize()
    assert tal_assign_cuda.launches == before + 1
    assert_tal_equal(got, task_aligned_assign(*args, topk=topk, num_classes=nc, impl="plain"))
    assert got.fg_mask.any()


@pytest.mark.cuda
def test_tal_kernel_reads_labels_and_mask_as_given(cuda):
    """int32 and float32 labels (out of range ones clamped), a float32 mask
    as (B, G, 1) and (B, G), and scores in the layout the loss hands them (a
    transposed view): the kernel reads each as given, with no copy before
    the launch."""
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    (scores, pbox, anc, glab, gbox, gmask), grid = tal_inputs(3, 12, 3, 128, cuda, 5)
    glab[1, :4] = torch.tensor([[-2], [7], [2], [1]], dtype=torch.int32)
    ref = task_aligned_assign(scores, pbox, anc, glab, gbox, gmask, num_classes=4, impl="plain")
    view = scores.transpose(1, 2).contiguous().transpose(1, 2)
    for lab, mask in ((glab.float(), gmask), (glab, gmask[..., 0])):
        assert_tal_equal(task_aligned_assign(view, pbox, anc, lab, gbox, mask, num_classes=4, grid=grid), ref)


@pytest.mark.cuda
def test_tal_kernel_rejects_other_alpha_beta(cuda):
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    args, grid = tal_inputs(2, 4, 1, 128, cuda, 0)
    with pytest.raises(ValueError, match="alpha"):
        task_aligned_assign(*args, beta=4.0, grid=grid)


@pytest.mark.cuda
def test_tal_kernel_raises_on_what_it_does_not_take(cuda):
    """No grid, a grid that does not cover A, topk above 16, fp64 boxes,
    int64 labels, a bool mask."""
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    args, grid = tal_inputs(2, 4, 1, 128, cuda, 0)
    with pytest.raises(ValueError, match="grid"):
        task_aligned_assign(*args)
    with pytest.raises(ValueError, match="grid"):
        task_aligned_assign(*args, grid=[(16, 16, 8), (8, 8, 16)])  # sum h * w = 320, A = 336
    with pytest.raises(ValueError, match="topk"):
        task_aligned_assign(*args, topk=17, grid=grid)
    with pytest.raises(ValueError, match="pd_bboxes"):
        task_aligned_assign(args[0], args[1].double(), *args[2:], grid=grid)
    with pytest.raises(ValueError, match="gt_labels"):
        task_aligned_assign(*args[:3], args[3].long(), *args[4:], grid=grid)
    with pytest.raises(ValueError, match="mask_gt"):
        task_aligned_assign(*args[:5], args[5] > 0, grid=grid)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["levels_swapped", "transposed", "anchors_shifted"])
def test_tal_kernel_is_exact_when_the_grid_does_not_describe_the_anchors(cuda, how):
    """A grid whose cells add up to A but whose centres are not the anchor
    points (two levels swapped; h and w transposed on a 96x128 rect batch;
    the right grid with every anchor moved by 3 px): the kernel finds the
    anchors off the grid and scans every anchor, exact against the plain
    version, which reads only the anchor points."""
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    args, grid = tal_numpy(2, 16, 2, 128 if how == "levels_swapped" else (96, 128), seed=3)
    if how == "levels_swapped":
        grid = [grid[1], grid[0], grid[2]]
    elif how == "transposed":
        grid = [(w, h, s) for h, w, s in grid]
    else:
        args = (*args[:2], args[2] + np.float32(3), *args[3:])
    args = to_device(args, cuda)
    got = task_aligned_assign(*args, num_classes=2, grid=grid)
    assert_tal_equal(got, task_aligned_assign(*args, num_classes=2, impl="plain"))
    assert got.fg_mask.any()


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


def check_int8_case(cuda, shape, heads, mode):
    """K4 (and K4v's bf16 softmax, sm16) vs swin_block_int8_plain. The
    integer sums are exact; fp32 sums in another order may move a value
    across a quantization boundary, which the later products carry: int8
    output within 3 levels and at most 1 % of it off, float output within
    3e-2 of its largest magnitude."""
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
@pytest.mark.parametrize("shape,heads", [((8, 40, 40, 256), 2), ((2, 20, 17, 256), 2), ((1, 12, 9, 128), 1),
                                         ((2, 14, 14, 128), 2), ((1, 9, 12, 192), 2)])
@pytest.mark.parametrize("mode", ["int8_io", "bf16_io", "fp32_io", "sm16_int8_io", "sm16_bf16_io"])
def test_int8_kernel_matches_plain(cuda, shape, heads, mode):
    """check_int8_case in every I/O mode. 40x40, 20x17, 12x9 and 9x12 pad to
    whole windows. Head dim 64 runs the attention tiles below the flagship's
    128; C=192 (head dim 96) is not a multiple of the products' 128-column
    blocks."""
    check_int8_case(cuda, shape, heads, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((8, 40, 40, 512), 2), ((2, 20, 17, 512), 2), ((1, 12, 9, 512), 4),
                                         ((2, 14, 14, 768), 2), ((1, 12, 17, 640), 2)])
@pytest.mark.parametrize("mode", ["int8_io", "bf16_io", "sm16_int8_io", "sm16_bf16_io"])
def test_int8_kernel_matches_plain_wide(cuda, shape, heads, mode):
    """check_int8_case where K4 takes its wide layout (bf16 compute from
    C=384 with 2 heads): the attention in 64-wide slices of the head, the MLP
    in hidden chunks whose int32 sums are dequantized once. From C=640 (2
    heads; yolo11x's 768) the fp32 residual stream stays in the global
    scratch for the whole block."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8

    c = shape[-1]
    assert S8.int8_is_wide(c, heads, True) and S8.int8_stream_in_global(c, heads, True) == (c >= 640)
    check_int8_case(cuda, shape, heads, mode)


@pytest.mark.cuda
def test_int8_model_runs_the_int8_kernel_and_int_mm_is_exact(cuda):
    """A quantized scale-n graph with one-head SwinBlocks launches K4 twice
    per forward and K1 twice per calibration batch; the int8 product of the
    convs is exact at the stem's K=27, at fewer than 17 rows and where one
    image's rows (min_rows) are 16 or fewer at a batch of several."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import quant as Q
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8

    for m, k, n, min_rows in ((5, 27, 16, 0), (4096, 288, 64, 0), (16, 64, 32, 16), (12, 27, 16, 4),
                              (48, 72, 8, 16), (1, 8, 8, 1)):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=cuda)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=cuda)
        assert torch.equal(Q.int_mm(a, w, min_rows), (a.double() @ w.double().t()).int())
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


@pytest.mark.cuda
@pytest.mark.parametrize("scale,k4", [("s", 2), ("n", 0)])
def test_yolo11_int8_launches_k4_where_the_head_dim_allows(cuda, scale, k4):
    """The fork's YOLO11 graph quantized on the card at 128 px: yolo11s
    (Swin C=256, head dim 128) runs K4 twice a forward; yolo11n (head dim
    64) keeps the float SwinBlock (K1), as the JAX package's gate says.
    Every grouped conv holds its quant buffers and keeps its float path."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import Conv
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8

    y = YOLO(f"yolo11{scale}-cbam-swin.yaml", device="cuda", dtype=torch.bfloat16,
             param_dtype=torch.float32).fuse()
    frames = np.random.default_rng(0).integers(0, 256, (2, 2, 128, 128, 3), dtype=np.uint8)
    quantize_model(y.model, list(frames))
    convs = [m for m in y.model.modules() if isinstance(m, Conv)]
    grouped = [m for m in convs if m.conv.groups > 1]
    assert grouped and all(m.w_int8 is not None and not m.runs_int8 for m in grouped)
    assert all(m.runs_int8 for m in convs if m.conv.groups == 1)
    f0, k0 = S.swin_block_cuda.launches, S8.swin_block_int8_cuda.launches
    res = y.predict(frames[0, 0], imgsz=128, conf=0.001, verbose=False)
    assert S8.swin_block_int8_cuda.launches - k0 == k4 and S.swin_block_cuda.launches - f0 == 2 - k4
    assert np.isfinite(res[0].boxes.data).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_ckpt_round_trip_on_the_card(cuda, tmp_path, fused):
    """A JAX-format .ckpt written from a model on the card and read back onto
    the card: the same state, bit for bit, in the same dtypes (bf16 compute
    over fp32 masters), and the same detections."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    build = dict(device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    y = YOLO("yolov8n-cbam-swin.yaml", seed=1, **build)
    if fused:
        y.fuse()
    y.save(str(tmp_path / "m.ckpt"))
    back = YOLO(str(tmp_path / "m.ckpt"), **build)
    a, b = y.model.state_dict(), back.model.state_dict()
    assert back.is_fused == fused and a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and a[k].is_cuda and torch.equal(a[k], b[k]) for k in a)
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    r1 = y.predict(frames, imgsz=128, conf=0.001, verbose=False)
    r2 = back.predict(frames, imgsz=128, conf=0.001, verbose=False)
    assert all(np.array_equal(p.boxes.data, q.boxes.data) for p, q in zip(r1, r2))


@pytest.mark.cuda
def test_swin_operators_pass_opcheck_on_the_card(cuda):
    """The two SwinBlock operators (K1's and K4's), with the kernels behind them:
    schema, fake (shape) implementation and a traced call."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8

    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(0, 1, (2, 9, 8, 128)).astype(np.float32), device=cuda)
    for dtype, fast in ((torch.bfloat16, True), (torch.float32, False)):
        p = swin_params(128, rng, cuda, dtype)
        torch.library.opcheck(S.swin_block_op, (x.to(dtype), [p[k] for k in S.PKEYS], 2, 7, fast))
    p = swin_params(128, rng, cuda, torch.float32)
    q = int8_quant(x, p, 1)
    xq = S8.q8(x.float(), q["x_in_scale"]).to(torch.int8)
    pv, qv = [p[k] for k in S8._VECTORS], [q[k] for k in S8.QNAMES]
    before = S8.swin_block_int8_cuda.launches
    for xin, in8, out8 in ((xq, True, True), (x.to(torch.bfloat16), False, False)):
        torch.library.opcheck(S8.swin_block_int8_op, (xin, pv, qv, 1, 7, in8, out8, False))
    assert S8.swin_block_int8_cuda.launches > before


@pytest.mark.cuda
def test_pt2_program_launches_k1_on_the_card(cuda, tmp_path):
    """A dynamic bf16 program of scale n exported on the card: loaded by
    Backend it launches K1 twice a call at batches 1 and 3 and gives the live
    model's output; a static fp32 program refuses another batch."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend

    y = YOLO("yolov8n-cbam-swin.yaml", device="cuda", dtype=torch.bfloat16).fuse()
    be = Backend(y.export(imgsz=128, half=True, dynamic=True, project=str(tmp_path)))
    live = Backend(y.model)
    for b in (1, 3):
        img = np.random.default_rng(b).integers(0, 256, (b, 128, 128, 3), dtype=np.uint8)
        before = S.swin_block_cuda.launches
        out = be(img)
        assert S.swin_block_cuda.launches - before == 2
        ref = live(img)
        assert np.abs(out - ref).max() <= 3e-2 * np.abs(ref).max()
    be32 = Backend(YOLO("yolov8n-cbam-swin.yaml", device="cuda").export(imgsz=128, batch=2, project=str(tmp_path)))
    with pytest.raises(Exception):
        be32(np.zeros((3, 128, 128, 3), np.uint8))


@pytest.mark.cuda
def test_embed_equals_a_forward_hook_on_the_card(cuda):
    """YOLO.embed at scale n in bf16: the layer before Detect (25) mean-pooled,
    bit for bit what a forward hook on that layer pools in the same forward,
    with K1 launched at both Swin sites."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    y = YOLO("yolov8n-cbam-swin.yaml", device="cuda", dtype=torch.bfloat16)
    frames = np.random.default_rng(4).integers(0, 256, (3, 96, 128, 3), dtype=np.uint8)
    pooled = []
    hook = y.model.model[25].register_forward_hook(lambda m, i, o: pooled.append(o.mean((2, 3)).float().cpu()))
    before = S.swin_block_cuda.launches
    try:
        e = y.embed(frames, imgsz=128)
    finally:
        hook.remove()
    assert S.swin_block_cuda.launches - before == 2
    assert e.shape == (3, 256) and e.dtype == np.float32 and np.isfinite(e).all()
    assert len(pooled) == 1 and np.array_equal(e, pooled[0].numpy())


@pytest.mark.cuda
def test_track_gives_seven_column_boxes_on_the_card(cuda):
    """YOLO.track with ByteTrack over 4 frames at scale n: 7-column boxes
    [x1, y1, x2, y2, id, conf, cls] whose ids are the Results' track_ids, K1
    launched twice for the one batch."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    y = YOLO("yolov8n-cbam-swin.yaml", device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():  # the class biases at 0, not the priors: the tracker at full load, scores near 0.5
        for seq in y.model.model[-1].cv3:
            seq[-1].bias.zero_()
    frames = list(np.random.default_rng(5).integers(0, 256, (4, 96, 128, 3), dtype=np.uint8))
    before = S.swin_block_cuda.launches
    res = y.track(frames, tracker="bytetrack.yaml", imgsz=128, conf=0.1, batch=4, verbose=False)
    assert S.swin_block_cuda.launches - before == 2 and len(res) == 4
    assert res[0].boxes.data.shape[1] == 7 and res[0].boxes.id.min() == 1
    for r in res:
        if len(r.track_ids):
            assert r.boxes.data.shape[1] == 7 and np.array_equal(r.boxes.id.astype(int), r.track_ids)


@pytest.mark.cuda
def test_yolov10_micro_step_launches_k2_twice_and_equals_plain(cuda):
    """One micro-step of yolov10n (batch 4, 320 px, bf16 over fp32 masters)
    launches K2 twice (one-to-many at topk 10, one-to-one at topk 1), and
    the same micro-step from the same state and batch with the plain
    assigner gives the same loss items and grads: K2 is exact."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda

    tr = DetectionTrainer(overrides={"model": "yolov10n.yaml", "batch": 4, "nbs": 64, "imgsz": 320,
                                     "device_augment": False, "seed": 0}).setup()
    step, acc = tr._make_train_step(nb=100)
    rng = np.random.default_rng(0)
    xy, wh = rng.uniform(0.2, 0.8, (4, 8, 2)), rng.uniform(0.05, 0.4, (4, 8, 2))
    batch = {"img": torch.tensor(rng.integers(0, 256, (4, 320, 320, 3), dtype=np.uint8), device=cuda),
             "cls": torch.zeros(4, 8, dtype=torch.int32, device=cuda),
             "bboxes": torch.tensor(np.concatenate([xy, wh], -1).astype(np.float32), device=cuda),
             "mask": torch.tensor((rng.random((4, 8)) < 0.6).astype(np.float32), device=cuda)}
    state = {k: v.clone() for k, v in tr.model.state_dict().items()}
    runs = []
    for impl in (None, "plain"):
        tr.model.load_state_dict(state)
        tr.step, tr.tal_impl = 0, impl
        before = tal_assign_cuda.launches
        items = step(batch)
        torch.cuda.synchronize()
        runs.append((tal_assign_cuda.launches - before, items.clone(),
                     {n: p.grad.clone() for n, p in tr.model.named_parameters() if p.grad is not None}))
        for p in tr.model.parameters():
            p.grad = None
    (k_launches, k_items, k_grads), (p_launches, p_items, p_grads) = runs
    assert acc > 1 and (k_launches, p_launches) == (2, 0)
    assert torch.isfinite(k_items).all()
    torch.testing.assert_close(k_items, p_items, rtol=1e-5, atol=0.0)
    assert k_grads.keys() == p_grads.keys() and any(n.startswith("model.23.one2one_") for n in k_grads)
    for n, g in k_grads.items():
        torch.testing.assert_close(g, p_grads[n], rtol=1e-3, atol=1e-6 * max(1.0, p_grads[n].abs().max().item()))


@pytest.mark.cuda
def test_seg_micro_step_launches_k2_once_and_equals_the_plain_assigner(cuda):
    """A seg graph's train micro-step (yolov8n-seg, nc 2, 160 px, batch 2,
    fp32 with TF32 off, the seg loss over a loader-format batch with an
    overlap map) launches K2 once; with the plain assigner instead, the four
    loss items agree within 1e-5 and every gradient within 1e-4 of its
    tensor's norm."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda

    cfg = yaml_model_load("yolov8n-seg.yaml")
    cfg["nc"] = 2
    rng = np.random.default_rng(4)
    xy, wh = rng.uniform(0.2, 0.8, (2, 8, 2)), rng.uniform(0.1, 0.3, (2, 8, 2))
    seg = np.zeros((2, 40, 40), np.int32)
    for b in range(2):
        for j in range(8):
            x1, y1 = ((xy[b, j] - wh[b, j] / 2) * 40).astype(int)
            x2, y2 = ((xy[b, j] + wh[b, j] / 2) * 40).astype(int)
            seg[b, max(y1, 0):y2, max(x1, 0):x2] = j + 1
    batch = {"img": rng.integers(0, 256, (2, 160, 160, 3), dtype=np.uint8),
             "cls": rng.integers(0, 2, (2, 8)).astype(np.float32),
             "bboxes": np.concatenate([xy, wh], -1).astype(np.float32), "mask": np.ones((2, 8), np.float32),
             "seg_map": seg}
    out = {}
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for impl in (None, "plain"):
            tr = DetectionTrainer(overrides={"model": cfg, "batch": 2, "nbs": 4, "imgsz": 160, "amp": False}).setup()
            tr.tal_impl = impl
            step, _ = tr._make_train_step(nb=10)
            before = tal_assign_cuda.launches
            items = step(batch)
            torch.cuda.synchronize()
            out[impl] = (items, {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()},
                         tal_assign_cuda.launches - before)
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
    (ik, gk, nk), (ip, gp, npl) = out[None], out["plain"]
    assert nk == 1 and npl == 0 and ik.shape == (4,)
    torch.testing.assert_close(ik, ip, rtol=1e-5, atol=0)
    for n in gp:
        assert (gk[n] - gp[n]).norm() <= 1e-4 * gp[n].norm().clamp(min=1e-12), n


# the card's int8 graph against the same quantized model on the CPU: the int8 sums are exact on both, the
# float layers (BN-folded biases, grouped and transposed convs, attention) sum in another order, which can move
# a value across the next conv's quantization boundary, a level that the layers after it carry
INT8_CPU_MAX, INT8_CPU_MEAN = 5e-2, 5e-3


@pytest.mark.cuda
def test_quantized_graph_on_the_card_equals_its_cpu_run(cuda):
    """yolov9t (RepConv branches float), fp32 compute, quantized on the card
    on seeded frames at 128 px, then copied to the CPU: the decoded output
    of both within INT8_CPU_MAX of the largest magnitude (INT8_CPU_MEAN on
    average), TF32 off on the card."""
    import copy

    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model

    y = YOLO("yolov9t.yaml", device="cuda", param_dtype=torch.float32).fuse()
    frames = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    quantize_model(y.model, [frames])
    cpu = copy.deepcopy(y.model).to("cpu")
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            got = y.model(x.to(cuda).contiguous(memory_format=torch.channels_last))[0].cpu()
            ref = cpu(x.contiguous(memory_format=torch.channels_last))[0]
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    d, top = (got - ref).abs(), ref.abs().max()
    assert got.shape == ref.shape == (2, 84, 336) and torch.isfinite(got).all()
    assert d.max() <= INT8_CPU_MAX * top and d.mean() <= INT8_CPU_MEAN * top


@pytest.mark.cuda
def test_seg_program_serves_masks_on_the_card(cuda, tmp_path):
    """yolov8n-seg exported on the card (bf16, dynamic batch), loaded by
    YOLO(path): the boxes and masks of its predict equal the live model's
    bit for bit at batches 1 and 3."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    y = YOLO("yolov8n-seg.yaml", device="cuda", dtype=torch.bfloat16).fuse()
    with torch.no_grad():
        for head in [y.model.model[-1]]:
            for seq in head.cv3:
                seq[-1].bias.zero_()  # seeded class priors at 0: scores near 0.5, so that boxes come
    path = y.export(imgsz=320, dynamic=True, half=True, project=str(tmp_path))
    served = YOLO(path)
    assert served.task == "segment"
    frames = [np.random.default_rng(i).integers(0, 256, (240, 320, 3), dtype=np.uint8) for i in range(3)]
    for b in (1, 3):
        got = served.predict(frames, conf=0.25, batch=b, verbose=False)
        ref = y.predict(frames, imgsz=320, conf=0.25, batch=b, verbose=False)
        assert sum(len(r) for r in ref) > 0
        for g, r in zip(got, ref):
            assert np.array_equal(g.boxes.data, r.boxes.data) and np.array_equal(g.masks.data, r.masks.data)


@pytest.mark.cuda
def test_pose_micro_step_launches_k2_once_and_equals_the_plain_assigner(cuda):
    """A pose graph's train micro-step (yolov8n-pose, nc 2, 160 px, batch 2,
    fp32 with TF32 off, the pose loss over a loader-format batch with 17
    keypoints a box, visibilities 0, 1 and 2) launches K2 once; with the
    plain assigner instead, the five loss items agree within 1e-5 and every
    gradient within 1e-4 of its tensor's norm."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda

    cfg = yaml_model_load("yolov8n-pose.yaml")
    cfg["nc"] = 2
    rng = np.random.default_rng(5)
    xy, wh = rng.uniform(0.2, 0.8, (2, 8, 2)), rng.uniform(0.1, 0.3, (2, 8, 2))
    kxy = np.clip(xy[:, :, None] + rng.uniform(-0.5, 0.5, (2, 8, 17, 2)) * wh[:, :, None], 0, 1)
    kpts = np.concatenate([kxy, rng.integers(0, 3, (2, 8, 17, 1))], -1).astype(np.float32)
    batch = {"img": rng.integers(0, 256, (2, 160, 160, 3), dtype=np.uint8),
             "cls": rng.integers(0, 2, (2, 8)).astype(np.float32),
             "bboxes": np.concatenate([xy, wh], -1).astype(np.float32), "mask": np.ones((2, 8), np.float32),
             "kpts": kpts}
    out = {}
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for impl in (None, "plain"):
            tr = DetectionTrainer(overrides={"model": cfg, "batch": 2, "nbs": 4, "imgsz": 160, "amp": False}).setup()
            tr.tal_impl = impl
            step, _ = tr._make_train_step(nb=10)
            before = tal_assign_cuda.launches
            items = step(batch)
            torch.cuda.synchronize()
            out[impl] = (items, {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()},
                         tal_assign_cuda.launches - before)
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
    (ik, gk, nk), (ip, gp, npl) = out[None], out["plain"]
    assert nk == 1 and npl == 0 and ik.shape == (5,) and float(ik[1]) > 0 and float(ik[2]) > 0
    torch.testing.assert_close(ik, ip, rtol=1e-5, atol=0)
    for n in gp:
        assert (gk[n] - gp[n]).norm() <= 1e-4 * gp[n].norm().clamp(min=1e-12), n


@pytest.mark.cuda
def test_pose_program_keeps_its_keypoints_on_the_card(cuda, tmp_path):
    """yolov8n-pose exported on the card (bf16, dynamic batch), loaded by
    YOLO(path): the boxes and keypoints of its predict equal the live
    model's bit for bit at batches 1 and 3."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    y = YOLO("yolov8n-pose.yaml", device="cuda", dtype=torch.bfloat16).fuse()
    with torch.no_grad():
        for seq in y.model.model[-1].cv3:
            seq[-1].bias.zero_()  # seeded class priors at 0: scores near 0.5, so that boxes come
    path = y.export(imgsz=320, dynamic=True, half=True, project=str(tmp_path))
    served = YOLO(path)
    assert served.task == "pose" and served.model.kpt_shape == (17, 3)
    frames = [np.random.default_rng(i).integers(0, 256, (240, 320, 3), dtype=np.uint8) for i in range(3)]
    for b in (1, 3):
        got = served.predict(frames, conf=0.25, batch=b, verbose=False)
        ref = y.predict(frames, imgsz=320, conf=0.25, batch=b, verbose=False)
        assert sum(len(r) for r in ref) > 0
        for g, r in zip(got, ref):
            assert np.array_equal(g.boxes.data, r.boxes.data)
            assert (g.keypoints is None) == (r.keypoints is None)
            assert g.keypoints is None or np.array_equal(g.keypoints.data, r.keypoints.data)


@pytest.mark.cuda
def test_obb_micro_step_on_the_card_equals_the_cpu(cuda):
    """An OBB graph's train micro-step (yolov8n-obb, nc 2, 160 px, batch 2,
    fp32 with TF32 off, the OBB loss over a loader-format batch of rotated
    boxes) launches no kernel (the rotated assigner is plain PyTorch, as
    the JAX package's is plain JAX); the card's three loss items agree with
    the same step on the CPU within 1e-4 and every gradient within 1e-3 of
    its tensor's norm."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda

    cfg = yaml_model_load("yolov8n-obb.yaml")
    cfg["nc"] = 2
    rng = np.random.default_rng(6)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (2, 8, 2)), rng.uniform(0.1, 0.3, (2, 8, 2)),
                            rng.uniform(-np.pi / 2, 0, (2, 8, 1))], -1).astype(np.float32)
    batch = {"img": rng.integers(0, 256, (2, 160, 160, 3), dtype=np.uint8),
             "cls": rng.integers(0, 2, (2, 8)).astype(np.float32), "bboxes": boxes, "mask": np.ones((2, 8), np.float32)}
    out = {}
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            tr = DetectionTrainer(overrides={"model": cfg, "batch": 2, "nbs": 4, "imgsz": 160, "amp": False},
                                  device=dev).setup()
            step, _ = tr._make_train_step(nb=10)
            before = tal_assign_cuda.launches
            items = step(batch)
            out[dev] = (items.cpu(), {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()},
                        tal_assign_cuda.launches - before)
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
    (ik, gk, nk), (ic, gc, _) = out["cuda"], out["cpu"]
    assert nk == 0 and ik.shape == (3,) and bool((ik > 0).all())
    torch.testing.assert_close(ik, ic, rtol=1e-4, atol=0)
    for n in gc:
        assert (gk[n] - gc[n]).norm() <= 1e-3 * gc[n].norm().clamp(min=1e-12), n


@pytest.mark.cuda
def test_obb_program_keeps_its_rotated_boxes_on_the_card(cuda, tmp_path):
    """yolov8n-obb exported on the card (bf16, dynamic batch), loaded by
    YOLO(path): the enclosing boxes and the oriented boxes of its predict
    equal the live model's bit for bit at batches 1 and 3."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    y = YOLO("yolov8n-obb.yaml", device="cuda", dtype=torch.bfloat16).fuse()
    with torch.no_grad():
        for seq in y.model.model[-1].cv3:
            seq[-1].bias.zero_()  # seeded class priors at 0: scores near 0.5, so that boxes come
    path = y.export(imgsz=320, dynamic=True, half=True, project=str(tmp_path))
    served = YOLO(path)
    assert served.task == "obb"
    frames = [np.random.default_rng(i).integers(0, 256, (240, 320, 3), dtype=np.uint8) for i in range(3)]
    for b in (1, 3):
        got = served.predict(frames, conf=0.25, batch=b, verbose=False)
        ref = y.predict(frames, imgsz=320, conf=0.25, batch=b, verbose=False)
        assert sum(len(r) for r in ref) > 0
        for g, r in zip(got, ref):
            assert np.array_equal(g.boxes.data, r.boxes.data)
            assert (g.obb is None) == (r.obb is None)
            assert g.obb is None or np.array_equal(g.obb.data, r.obb.data)


@pytest.mark.cuda
def test_classify_forward_on_the_card_equals_the_cpu(cuda):
    """yolov8s-cls (nc 1000) and yolo11-cls-resnet18 at 224 px in fp32 with
    TF32 off: the card's eval softmax equals the same weights' on the CPU
    within 1e-4 of its largest value, the train logits within 1e-3 of
    theirs; no kernel runs (no SwinBlock, no assigner)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel

    x = torch.rand(4, 3, 224, 224, generator=torch.Generator().manual_seed(3))
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for cfg in ("yolov8s-cls.yaml", "yolo11-cls-resnet18.yaml"):
            cpu = DetectionModel(cfg, device="cpu")
            card = DetectionModel(cfg, device="cuda")
            card.load_state_dict(cpu.state_dict())
            before = S.swin_block_cuda.launches
            with torch.no_grad():
                got, want = card(x.to(cuda)).cpu(), cpu(x)
                got_t, want_t = card.train()(x.to(cuda)).cpu(), cpu.train()(x)
            assert S.swin_block_cuda.launches == before and card.task == "classify" and got.shape == (4, 1000)
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
            assert (got_t - want_t).abs().max() <= 1e-3 * want_t.abs().max()
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32


@pytest.mark.cuda
def test_classify_predict_and_program_on_the_card(cuda, tmp_path):
    """yolov8n-cls in bf16 on the card: predict gives each frame's probs
    (summing to 1 within 1e-5) and top5; a dynamic program of it served by
    YOLO(path) gives the live model's probs bit for bit at batches 1 and 3."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    y = YOLO("yolov8n-cls.yaml", device="cuda", dtype=torch.bfloat16).fuse()
    frames = [np.random.default_rng(i).integers(0, 256, (240, 320, 3), dtype=np.uint8) for i in range(3)]
    res = y.predict(frames, imgsz=224, batch=3, verbose=False)
    assert all(abs(r.probs.data.sum() - 1) < 1e-5 and len(r.probs.top5) == 5 for r in res)
    path = y.export(imgsz=224, dynamic=True, half=True, project=str(tmp_path))
    served = YOLO(path)
    assert served.task == "classify"
    for b in (1, 3):
        got = served.predict(frames, batch=b, verbose=False)
        ref = y.predict(frames, imgsz=224, batch=b, verbose=False)
        for g, r in zip(got, ref):
            assert np.array_equal(g.probs.data, r.probs.data)


# the JAX package's tiny RT-DETR graph (tests/test_rtdetr.py): 2 decoder layers, 16 queries
TINY_RTDETR = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                                     [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [48, 3, 2]],
                                     [-1, 1, "Conv", [64, 3, 2]]],
               "head": [[-1, 1, "AIFI", [64, 4]], [[2, 3, 5], 1, "RTDETRDecoder", ["nc", 32, 16, 2, 4, 2, 64]]]}


@pytest.fixture
def no_tf32_convs():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
def test_rtdetr_l_forward_on_the_card_equals_the_cpu(cuda, no_tf32_convs):
    """rtdetr-l (nc 80) at 320 px, batch 2, fp32 with TF32 off, seeded
    weights with the score heads' bias priors zeroed and the box heads'
    last layers and the deformable attention's sampling_offsets and
    attention_weights matrices drawn (chip_smoke.draw_query_paths, normal
    0.02; seeded, they are 0, every box is its anchor and the sampling does
    not depend on the query): the queries matched by their anchor (the top-k orders scores
    that the two devices round apart), at least 99 % of the CPU's anchors
    selected on the card too, those queries' boxes and scores within 1e-3
    of the CPU's largest value; no kernel runs."""
    from chip_smoke import draw_query_paths, rtdetr_queries
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel

    cpu = DetectionModel("rtdetr-l.yaml", device="cpu")
    head = cpu.model[-1]
    with torch.no_grad():
        for lin in (head.enc_score_head, *head.dec_score_head):
            lin.bias.zero_()
    draw_query_paths(cpu, seed=5)
    card = DetectionModel("rtdetr-l.yaml", device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 3, 320, 320, generator=torch.Generator().manual_seed(4))
    before = S.swin_block_cuda.launches
    (got, a_card), (want, a_cpu) = rtdetr_queries(card, x.to(cuda)), rtdetr_queries(cpu, x)
    assert S.swin_block_cuda.launches == before and got.shape == want.shape == (2, 300, 84)
    got, a_card = got.cpu(), a_card.cpu()
    shared = 0
    for b in range(2):
        pos = {int(a): i for i, a in enumerate(a_card[b].tolist())}
        rows = [(i, pos[int(a)]) for i, a in enumerate(a_cpu[b].tolist()) if int(a) in pos]
        shared += len(rows)
        i, j = (torch.tensor(r) for r in zip(*rows))
        assert (got[b, j] - want[b, i]).abs().max() <= 1e-3 * want.abs().max()
    assert shared >= 0.99 * 600


@pytest.mark.cuda
def test_rtdetr_loss_on_the_card_equals_the_cpu(cuda, no_tf32_convs):
    """The tiny graph's train dict and its Hungarian-matched loss in fp32 on
    the card and on the CPU, with the same weights (the query paths drawn,
    chip_smoke.draw_query_paths), batch and denoising draws: the assignment of every matched layer equal, the total and the
    (giou, cls, l1) items within 1e-4 of their size."""
    from chip_smoke import draw_query_paths
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.transformer import cdn_draws
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.detr_loss import hungarian_assign, rtdetr_loss

    cpu = DetectionModel(TINY_RTDETR, device="cpu").train()
    draw_query_paths(cpu, seed=3)
    card = DetectionModel(TINY_RTDETR, device="cuda").train()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
    cls = torch.tensor([[0, 1, 2, 0], [2, 1, 0, 0]])
    box = torch.tensor(np.concatenate([rng.uniform(0.2, 0.6, (2, 4, 2)), rng.uniform(0.1, 0.4, (2, 4, 2))], -1),
                       dtype=torch.float32)
    mask = torch.tensor([[1, 1, 1, 0], [1, 1, 0, 0]], dtype=torch.float32)
    box = box * mask[..., None]
    draws = cdn_draws(2, 200, 3, torch.Generator().manual_seed(1), "cpu")
    out = []
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        t = {"cls": cls.to(dev), "bboxes": box.to(dev), "mask": mask.to(dev),
             "dn_draws": {k: v.to(dev) for k, v in draws.items()}}
        preds = m(x.to(dev), targets=t)
        num_dn = preds["dec_bboxes"].shape[2] - preds["enc_bboxes"].shape[1]
        main_b = torch.cat([preds["enc_bboxes"][None], preds["dec_bboxes"][:, :, num_dn:]], 0)
        main_s = torch.cat([preds["enc_scores"][None], preds["dec_scores"][:, :, num_dn:]], 0)
        q = hungarian_assign(main_b, main_s, t["bboxes"], t["cls"], t["mask"] > 0).cpu()
        total, items = rtdetr_loss(preds, t["cls"], t["bboxes"], t["mask"], 3, num_dn=num_dn)
        out.append((q, torch.stack([total, *items]).detach().cpu()))
    assert bool(((out[0][0] == out[1][0]) | (mask == 0)).all())  # every image's real GT slots
    assert (out[1][1] - out[0][1]).abs().max() <= 1e-4 * out[0][1].abs().max()


@pytest.mark.cuda
def test_rtdetr_yolo_train_two_micro_steps_on_the_card(cuda, tmp_path):
    """YOLO.train of the tiny graph on the card: two epochs of one micro-step
    each on the same two images (augmentation off), SGD: the logged giou,
    cls and l1 losses finite, and their sum lower after the first step."""
    import json

    from chip_smoke import png_bytes
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        (tmp_path / "images" / split).mkdir(parents=True)
        (tmp_path / "labels" / split).mkdir(parents=True)
        for i in range(2):
            img = rng.integers(0, 60, (64, 64, 3), dtype=np.uint8)
            img[16:40, 8:32] = (255, 64, 64)
            (tmp_path / "images" / split / f"{i}.png").write_bytes(png_bytes(img))
            (tmp_path / "labels" / split / f"{i}.txt").write_text("1 0.3125 0.4375 0.375 0.375\n")
    data = tmp_path / "data.yaml"
    data.write_text(json.dumps({"path": str(tmp_path), "train": "images/train", "val": "images/val", "nc": 3,
                                "names": {"0": "a", "1": "b", "2": "c"}}))
    y = YOLO(TINY_RTDETR, device="cuda")
    y.train(data=str(data), epochs=2, batch=2, nbs=2, imgsz=64, max_gt=4, workers=0, val=False, optimizer="SGD",
            lr0=0.02, warmup_epochs=0.0, mosaic=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, fliplr=0.0, translate=0.0,
            scale=0.0, close_mosaic=0, plots=False, project=str(tmp_path / "runs"))
    sums = [sum(r[k] for k in ("train/giou_loss", "train/cls_loss", "train/l1_loss")) for r in y.trainer.metrics_rows]
    assert len(sums) == 2 and np.isfinite(sums).all() and sums[1] < sums[0]


# the JAX package's tiny World graph (tests/test_world.py): C2fAttn at P5, ImagePoolingAttn, C2fAttn at P3 and P4,
# WorldDetect scoring 512-wide embeddings
TINY_WORLD = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                                    [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [48, 3, 2]],
                                    [-1, 1, "Conv", [64, 3, 2]]],
              "head": [[-1, 1, "C2fAttn", [64, 32, 2]], [[2, 3, -1], 1, "ImagePoolingAttn", [32]],
                       [2, 1, "C2fAttn", [32, 16, 1]], [3, 1, "C2fAttn", [48, 16, 1]],
                       [[7, 8, 5], 1, "WorldDetect", ["nc", 512, False]]]}
WORLD_PROMPTS = ["person", "bicycle", "car", "dog", "kite"]


@pytest.mark.cuda
def test_world_forward_on_the_card_equals_the_cpu(cuda, no_tf32_convs):
    """The tiny World graph at five prompts, its Convs at unit gain and its
    class prior zeroed (chip_smoke.unit_gain: the seeded features would
    reach the head near constant), fp32 with TF32 off, 64 px, batch 2: the
    card's prediction within 1e-4 of the CPU's largest magnitude, its class
    scores spread, its text features the CPU's bit for bit (the hash
    projection is numpy)."""
    from chip_smoke import unit_gain
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel

    cpu = DetectionModel(dict(TINY_WORLD), device="cpu")
    cpu.set_classes(WORLD_PROMPTS)
    unit_gain(cpu)
    with torch.no_grad():
        for h in cpu.model[-1].cv4:
            h.bias.zero_()
    card = DetectionModel(dict(TINY_WORLD), device="cuda")
    card.set_classes(WORLD_PROMPTS)
    card.load_state_dict(cpu.state_dict())
    assert torch.equal(card.txt_feats.cpu(), cpu.txt_feats)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, got = cpu(x)[0], card(x.to(cuda))[0].cpu()
    assert got.shape == want.shape == (2, 4 + 5, 84) and want[:, 4:].std() > 1e-2
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_world_micro_step_launches_k2_once_and_equals_the_plain_assigner(cuda, no_tf32_convs):
    """A World graph's train micro-step (the tiny graph at five prompts, 64
    px, batch 2, fp32 with TF32 off, the detect loss at nc 5) launches K2
    once; with the plain assigner instead, the three loss items agree within
    1e-5 and every gradient within 1e-4 of its tensor's norm, or within 1e-6
    of the largest gradient's norm where it is rounding noise (the attention
    keys' bias, which the softmax cancels)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda

    rng = np.random.default_rng(5)
    xy, wh = rng.uniform(0.25, 0.75, (2, 6, 2)), rng.uniform(0.15, 0.4, (2, 6, 2))
    batch = {"img": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
             "cls": rng.integers(0, 5, (2, 6)).astype(np.float32),
             "bboxes": np.concatenate([xy, wh], -1).astype(np.float32), "mask": np.ones((2, 6), np.float32)}
    out = {}
    for impl in (None, "plain"):
        tr = DetectionTrainer(overrides={"model": dict(TINY_WORLD), "batch": 2, "nbs": 4, "imgsz": 64,
                                         "amp": False}).setup()
        tr.model.set_classes(WORLD_PROMPTS)
        tr.tal_impl = impl
        step, _ = tr._make_train_step(nb=10)
        before = tal_assign_cuda.launches
        items = step(batch)
        torch.cuda.synchronize()
        out[impl] = (items, {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()},
                     tal_assign_cuda.launches - before)
    (ik, gk, nk), (ip, gp, npl) = out[None], out["plain"]
    assert nk == 1 and npl == 0 and ik.shape == (3,) and torch.isfinite(ik).all()
    torch.testing.assert_close(ik, ip, rtol=1e-5, atol=0)
    floor = 1e-6 * max(g.norm() for g in gp.values())
    for n in gp:
        assert (gk[n] - gp[n]).norm() <= torch.maximum(1e-4 * gp[n].norm(), floor), n


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["rtdetr", "world"])
def test_int8_program_of_the_query_and_world_graphs_on_the_card(cuda, tmp_path, graph):
    """The tiny RT-DETR and World graphs (class priors zeroed, BN-folded)
    exported int8 with a dynamic batch on the card: YOLO(path) serves
    batches 1 and 3 bit for bit with the live quantized model, the RT-DETR
    program's queries through the predictor's NMS-free path."""
    import copy

    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend

    y = YOLO(copy.deepcopy(TINY_RTDETR if graph == "rtdetr" else TINY_WORLD), device="cuda",
             param_dtype=torch.float32)
    if graph == "world":
        y.set_classes(WORLD_PROMPTS[:2])
    with torch.no_grad():
        for m in y.model.modules():
            if hasattr(m, "logit_scale"):
                m.bias.zero_()
    y.fuse()
    path = y.export(imgsz=64, int8=True, dynamic=True, project=str(tmp_path))
    rng = np.random.default_rng(0)  # the exporter's synthetic calibration frames
    live = copy.deepcopy(y)
    quantize_model(live.model, [rng.integers(0, 255, (8, 64, 64, 3), np.uint8) for _ in range(2)])
    served = YOLO(path)
    assert served.model.is_rtdetr == (graph == "rtdetr")
    for b in (1, 3):
        img = np.random.default_rng(b).integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
        assert np.array_equal(served.model.backend(img), Backend(live.model)(img))
    src = [np.random.default_rng(i).integers(0, 256, (48, 80, 3), dtype=np.uint8) for i in range(3)]
    got = served.predict(src, conf=0.25, batch=3, verbose=False)
    ref = live.predict(src, imgsz=64, conf=0.25, batch=3, verbose=False)
    assert sum(len(r) for r in ref) > 0
    assert all(np.array_equal(g.boxes.data, r.boxes.data) for g, r in zip(got, ref))
