"""The task-aligned assigner as a hand-written CUDA kernel (csrc/tal_assign.cu).

Replaces the TPU kernel `_tal_kernel` launched by `tal_assign_fused`
(improving_yolov8_cbam_swinblock_tpu/ops/pallas/tal_kernel.py). The plain
version is `utils.tal.task_aligned_assign_plain`; the dispatcher
`utils.tal.task_aligned_assign` chooses between the two by device.

One launch per call, over the candidate anchors only: the kernel walks each
GT's index rectangle on the anchor grid, so it needs the grid, one
(h, w, stride) per level, whose cell centres (i + 0.5) * stride are the
anchor points, level after level, row-major (`ops.anchors.make_anchors`
times the strides). The kernel checks that they are, bit for bit; an image
whose anchors are not is scanned over every anchor (same result, slower).
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_TOPK = 16  # the kernel spreads a GT's top-k list over the lanes of a warp
MAX_LEVELS = 8
LABEL_KINDS = {torch.int32: 0, torch.float32: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library, once per process.
    Built without FMA contraction, so that each operation rounds as the plain
    version's separate PyTorch ops do and near-tie picks agree exactly."""
    from .cuda_build import build

    lib = ctypes.CDLL(str(build("tal_assign", ("tal_assign.cu",), extra_flags=("-fmad=false",))))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.tal_assign.argtypes = ([i32] * 6 + [f32, ptr, i64, i64, i64] + [ptr, ptr, ptr, i32, ptr, ptr]
                               + [i32, ptr, ptr, ptr] + [ptr] * 5 + [ptr])
    lib.tal_assign.restype = i32
    lib.tal_assign_config.argtypes = [i32, i32, i32, i32, ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(i32)]
    lib.tal_assign_config.restype = i32
    return lib


@functools.lru_cache(maxsize=16)
def _levels(grid: tuple):
    """ctypes arrays of the levels' heights, widths and strides."""
    n = len(grid)
    return ((ctypes.c_int * n)(*(h for h, _, _ in grid)), (ctypes.c_int * n)(*(w for _, w, _ in grid)),
            (ctypes.c_float * n)(*(s for _, _, s in grid)))


def launch_config(b: int, a: int, g: int, k: int = 10):
    """(blocks per image, shared memory bytes per block, clusters of that
    shape the card holds at once) that the kernel uses for B=b, A=a, G=g,
    topk=k on the current card; (0, 0, 0) if none fits."""
    smem, active = ctypes.c_size_t(), ctypes.c_int()
    cs = _lib().tal_assign_config(b, a, g, k, ctypes.byref(smem), ctypes.byref(active))
    return (cs, smem.value, active.value) if cs else (0, 0, 0)


def _check(t: torch.Tensor, name: str, dtype, shape, align: int = 4) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"tal_assign kernel: {name} must be a contiguous {dtype} tensor of shape {shape} "
                         f"aligned to {align} bytes, not {t.dtype} {tuple(t.shape)}")


def tal_assign_cuda(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, grid, topk: int = 10,
                    num_classes: int = 80, eps: float = 1e-9):
    """Launch the assigner on CUDA tensors (shapes as in utils.tal) ->
    (labels int32, boxes, scores, fg bool, gt index int32). `grid` is the
    anchor grid, one (h, w, stride) per level. pd_scores is fp32 in any
    layout; the boxes and anchors contiguous fp32; gt_labels int32 or float32
    and mask_gt float32, (B, G) or (B, G, 1), read as given (the loss hands
    them so). Raises on what the kernel does not take."""
    if not pd_scores.is_cuda:
        raise ValueError("tal_assign_cuda needs CUDA tensors")
    if grid is None:
        raise ValueError("tal_assign kernel needs the anchor grid: one (h, w, stride) per level")
    b, a, nc = pd_scores.shape
    g = gt_bboxes.shape[1]
    k = min(topk, a)
    grid = tuple((int(h), int(w), float(s)) for h, w, s in grid)
    if not 1 <= len(grid) <= MAX_LEVELS or sum(h * w for h, w, _ in grid) != a:
        raise ValueError(f"tal_assign kernel: the grid {grid} does not cover the {a} anchors "
                         f"(1 to {MAX_LEVELS} levels, sum of h * w == A)")
    if g < 1:
        raise ValueError("tal_assign kernel needs at least one GT row (masked rows are fine)")
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"tal_assign kernel takes 1 <= topk <= {MAX_TOPK}, not {topk}")
    if num_classes < nc:
        raise ValueError(f"num_classes={num_classes} is below the score width {nc}")
    if pd_scores.dtype != torch.float32:
        raise ValueError(f"tal_assign kernel: pd_scores must be float32, not {pd_scores.dtype}")
    _check(pd_bboxes, "pd_bboxes", torch.float32, (b, a, 4), 16)
    _check(anc_points, "anc_points", torch.float32, (a, 2), 8)
    _check(gt_bboxes, "gt_bboxes", torch.float32, (b, g, 4), 16)
    if gt_labels.dtype not in LABEL_KINDS or mask_gt.dtype != torch.float32:
        raise ValueError(f"tal_assign kernel: gt_labels {gt_labels.dtype} (takes {list(LABEL_KINDS)}) or "
                         f"mask_gt {mask_gt.dtype} (takes torch.float32)")
    for t, name in ((gt_labels, "gt_labels"), (mask_gt, "mask_gt")):
        if t.numel() != b * g or not t.is_contiguous():
            raise ValueError(f"tal_assign kernel: {name} must be contiguous with B*G = {b * g} elements")
    dev = pd_scores.device
    if any(t.device != dev for t in (pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt)):
        raise ValueError("tal_assign kernel: all inputs must be on one device")

    labels = torch.empty(b, a, device=dev, dtype=torch.int32)
    boxes = torch.empty(b, a, 4, device=dev, dtype=torch.float32)
    tscores = torch.empty(b, a, num_classes, device=dev, dtype=torch.float32)
    fg = torch.empty(b, a, device=dev, dtype=torch.bool)
    idx = torch.empty(b, a, device=dev, dtype=torch.int32)
    lev_h, lev_w, lev_s = _levels(grid)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.tal_assign(
            b, a, g, nc, num_classes, k, eps, pd_scores.data_ptr(), *pd_scores.stride(),
            pd_bboxes.data_ptr(), anc_points.data_ptr(), gt_labels.data_ptr(), LABEL_KINDS[gt_labels.dtype],
            mask_gt.data_ptr(), gt_bboxes.data_ptr(), len(grid), lev_h, lev_w, lev_s,
            labels.data_ptr(), boxes.data_ptr(), tscores.data_ptr(), fg.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc == -1:
        raise RuntimeError(f"tal_assign: no cluster of blocks fits the card for A={a}, G={g}")
    if rc != 0:
        raise RuntimeError(f"tal_assign launch failed with CUDA error {rc}")
    tal_assign_cuda.launches += 1
    return labels, boxes, tscores, fg, idx


tal_assign_cuda.launches = 0  # kernel launches since the last reset
