"""The task-aligned assigner as a hand-written CUDA kernel (csrc/tal_assign.cu).

Replaces the TPU kernel `_tal_kernel` launched by `tal_assign_fused`
(improving_yolov8_cbam_swinblock_tpu/ops/pallas/tal_kernel.py). The plain
version is `utils.tal.task_aligned_assign_plain`; the dispatcher
`utils.tal.task_aligned_assign` chooses between the two by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_TOPK = 16  # the kernel keeps a per-thread list of this many candidates


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library, once per process.
    Built without FMA contraction, so that each operation rounds as the plain
    version's separate PyTorch ops do and near-tie picks agree exactly."""
    from .cuda_build import build

    lib = ctypes.CDLL(str(build("tal_assign", ("tal_assign.cu",), extra_flags=("-fmad=false",))))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tal_assign.argtypes = [i32, i32, i32, i32, i32, i32, f32] + [ptr] * 6 + [ptr] * 5 + [ptr] * 7 + [ptr]
    lib.tal_assign.restype = i32
    return lib


def tal_assign_cuda(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk: int = 10,
                    num_classes: int = 80, eps: float = 1e-9):
    """Launch the assigner on CUDA tensors (shapes as in utils.tal) ->
    (labels int32, boxes, scores, fg bool, gt index int32). Any G is taken:
    the work is split into per-GT top-k blocks and per-anchor threads, so
    no (G, A) tile has to fit on chip. Raises on what it does not take."""
    if not pd_scores.is_cuda:
        raise ValueError("tal_assign_cuda needs CUDA tensors")
    b, a, nc = pd_scores.shape
    g = gt_bboxes.shape[1]
    k = min(topk, a)
    if g < 1:
        raise ValueError("tal_assign kernel needs at least one GT row (masked rows are fine)")
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"tal_assign kernel takes 1 <= topk <= {MAX_TOPK}, not {topk}")
    if num_classes < nc:
        raise ValueError(f"num_classes={num_classes} is below the score width {nc}")
    dev = pd_scores.device
    f32 = dict(device=dev, dtype=torch.float32)
    scores = pd_scores.to(**f32).contiguous()
    pbox = pd_bboxes.to(**f32).contiguous()
    anc = anc_points.to(**f32).contiguous()
    glab = gt_labels.reshape(b, g).to(device=dev, dtype=torch.int32).clamp(0, nc - 1).contiguous()
    gbox = gt_bboxes.to(**f32).contiguous()
    gmask = (mask_gt.reshape(b, g) > 0).to(device=dev, dtype=torch.int32).contiguous()
    if pbox.shape != (b, a, 4) or anc.shape != (a, 2) or gbox.shape != (b, g, 4):
        raise ValueError("tal_assign: shapes do not agree")

    labels = torch.empty(b, a, device=dev, dtype=torch.int32)
    boxes = torch.empty(b, a, 4, **f32)
    tscores = torch.empty(b, a, num_classes, **f32)
    fg = torch.empty(b, a, device=dev, dtype=torch.bool)
    idx = torch.empty(b, a, device=dev, dtype=torch.int32)
    # scratch: per-box atan, per-GT picks and maxima, per-anchor claim count / first claimant / align
    patan = torch.empty(b, a, **f32)
    gatan = torch.empty(max(b * g, 1), **f32)
    picks = torch.empty(max(b * g * k, 1), device=dev, dtype=torch.int32)
    pos_align = torch.empty(max(b * g, 1), **f32)
    pos_ovl = torch.empty(max(b * g, 1), **f32)
    claims = torch.empty(b, a, 2, device=dev, dtype=torch.int32)
    align_sel = torch.empty(b, a, **f32)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tal_assign(
            b, a, g, nc, num_classes, k, eps,
            scores.data_ptr(), pbox.data_ptr(), anc.data_ptr(), glab.data_ptr(), gbox.data_ptr(), gmask.data_ptr(),
            labels.data_ptr(), boxes.data_ptr(), tscores.data_ptr(), fg.data_ptr(), idx.data_ptr(),
            patan.data_ptr(), gatan.data_ptr(), picks.data_ptr(), pos_align.data_ptr(), pos_ovl.data_ptr(),
            claims.data_ptr(), align_sel.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"tal_assign launch failed with CUDA error {rc}")
    tal_assign_cuda.launches += 1
    return labels, boxes, tscores, fg, idx


tal_assign_cuda.launches = 0  # kernel launches since the last reset
