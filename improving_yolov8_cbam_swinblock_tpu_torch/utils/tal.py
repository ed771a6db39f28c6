"""Task-aligned assigner: the plain PyTorch version and the dispatcher.

Counterpart of the JAX package's utils/tal.py. `task_aligned_assign` sends a
CUDA tensor to the hand-written kernel (ops/tal.py, csrc/tal_assign.cu) and
a CPU tensor to `task_aligned_assign_plain`, which is the kernel's plain
version: the same candidate gate, CIoU with atan(w/h) once per box,
align = sqrt(score) * overlap^6, top-k per GT by iterative first-index
argmax, conflicts resolved by the highest CIoU over all GTs, exact gathers
and the same normalisation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.boxes import CIOU_EPS, ciou_xyxy

ALPHA, BETA = 0.5, 6.0  # the only (alpha, beta) the kernel takes, as in the JAX kernel


class TALResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int32
    target_bboxes: torch.Tensor  # (B, A, 4) xyxy
    target_scores: torch.Tensor  # (B, A, num_classes)
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int32


def box_atan(boxes: torch.Tensor) -> torch.Tensor:
    """atan(w / (h + eps)) of xyxy boxes (..., 4) -> (...): the CIoU aspect angle."""
    return torch.atan((boxes[..., 2] - boxes[..., 0]) / (boxes[..., 3] - boxes[..., 1] + CIOU_EPS))


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """(A, 2), (B, G, 4 xyxy) -> (B, G, A) bool: the anchor centre strictly inside the box."""
    xc, yc = xy_centers[:, 0], xy_centers[:, 1]
    lx, ly, rx, ry = (gt_bboxes[..., i, None] for i in range(4))
    return (xc - lx > eps) & (yc - ly > eps) & (rx - xc > eps) & (ry - yc > eps)


def select_highest_overlaps(mask_pos: torch.Tensor, overlaps: torch.Tensor):
    """mask_pos (B, G, A) bool, overlaps (B, G, A) -> (target_gt_idx (B, A),
    fg (B, A) bool, mask_pos): an anchor claimed by several GTs goes to the
    argmax of its overlaps over all GTs (the first among ties), and each
    anchor's GT is its first positive one, 0 where it has none."""
    multi = mask_pos.sum(1) > 1  # (B, A)
    is_max = torch.zeros_like(mask_pos).scatter_(1, overlaps.argmax(1, keepdim=True), True)
    mask_pos = torch.where(multi[:, None], is_max, mask_pos)
    return mask_pos.to(torch.uint8).argmax(1), mask_pos.any(1), mask_pos


def task_aligned_assign_plain(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk: int = 10,
                              num_classes: int = 80, alpha: float = ALPHA, beta: float = BETA,
                              eps: float = 1e-9) -> TALResult:
    """pd_scores (B, A, nc) sigmoid scores, pd_bboxes (B, A, 4) xyxy pixels,
    anc_points (A, 2) pixels, gt_labels (B, G, 1), gt_bboxes (B, G, 4) xyxy,
    mask_gt (B, G, 1) 0/1 -> TALResult, in fp32."""
    b, a, nc = pd_scores.shape
    g = gt_bboxes.shape[1]
    scores, pbox, gbox = pd_scores.float(), pd_bboxes.float(), gt_bboxes.float()
    anc = anc_points.float()
    gt_cls = gt_labels[..., 0].long().clamp(0, nc - 1)  # (B, G)
    cand = select_candidates_in_gts(anc, gbox, eps) & (mask_gt[..., 0] > 0)[..., None]  # (B, G, A)
    candf = cand.float()

    # per-GT class score of every anchor: an exact gather
    bbox_scores = torch.gather(scores.transpose(1, 2), 1, gt_cls[..., None].expand(b, g, a)) * candf
    ciou = ciou_xyxy(gbox[:, :, None, :], pbox[:, None, :, :], box_atan(gbox)[:, :, None], box_atan(pbox)[:, None, :])
    overlaps = ciou.clamp(min=0) * candf
    if (alpha, beta) == (ALPHA, BETA):
        o2 = overlaps * overlaps
        align = torch.sqrt(bbox_scores) * (o2 * o2 * o2)
    else:
        align = bbox_scores.pow(alpha) * overlaps.pow(beta)

    # top-k per GT: iterative argmax, the first index wins ties
    live = align.clone()
    mask_topk = torch.zeros_like(cand)
    for _ in range(min(topk, a)):
        hit = live.argmax(-1, keepdim=True)
        mask_topk.scatter_(-1, hit, True)
        live.scatter_(-1, hit, float("-inf"))
    mask_pos = mask_topk & cand

    tgt_idx, fg, mask_pos = select_highest_overlaps(mask_pos, overlaps)

    labels = torch.gather(gt_cls, 1, tgt_idx)
    boxes = torch.gather(gbox, 1, tgt_idx[..., None].expand(b, a, 4))

    align_pos = align * mask_pos
    pos_align = align_pos.amax(-1, keepdim=True)  # (B, G, 1)
    pos_ovl = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_pos * pos_ovl / (pos_align + eps)).amax(1)  # (B, A)
    tscores = torch.nn.functional.one_hot(labels, num_classes).float() * fg[..., None] * norm[..., None]
    return TALResult(labels.to(torch.int32), boxes, tscores, fg, tgt_idx.to(torch.int32))


def task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk: int = 10,
                        num_classes: int = 80, alpha: float = ALPHA, beta: float = BETA, eps: float = 1e-9,
                        impl: Optional[str] = None, grid: Optional[Sequence[Tuple[int, int, float]]] = None
                        ) -> TALResult:
    """The assigner: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. impl="plain" forces the plain version, to compare with the
    kernel on the card; the main path never passes it. The kernel has
    alpha=0.5, beta=6 built in and raises for any other value. `grid` is the
    anchor grid, one (h, w, stride) per level, whose cell centres are
    anc_points: the kernel needs it (and raises without it), the plain
    version ignores it."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', not {impl!r}")
    if impl == "plain" or pd_scores.device.type == "cpu":
        return task_aligned_assign_plain(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk,
                                         num_classes, alpha, beta, eps)
    if (alpha, beta) != (ALPHA, BETA):
        raise ValueError(f"the TAL kernel takes alpha={ALPHA}, beta={BETA} only, not ({alpha}, {beta})")
    from ..ops.tal import tal_assign_cuda

    return TALResult(*tal_assign_cuda(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, grid,
                                      topk, num_classes, eps))
