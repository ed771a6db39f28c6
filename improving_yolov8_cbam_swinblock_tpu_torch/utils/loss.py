"""YOLOv8 detection loss: BCE + CIoU + DFL, in fp32.

Counterpart of the JAX package's utils/loss.py `detection_loss`: targets
arrive padded, (B, G) classes, (B, G, 4) normalised xywh and a (B, G)
validity mask; the task-aligned assigner (utils/tal.py: the CUDA kernel on
the card) runs without gradient; the gains are 7.5 / 0.5 / 1.5 and the
total is multiplied by the batch size. A YOLOv10 head's two branches add
their losses (topk 10 and 1), as the JAX trainer adds them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.anchors import bbox2dist, make_anchors
from ..ops.boxes import ciou_xyxy, xywh2xyxy
from .tal import task_aligned_assign


class LossMetrics(NamedTuple):
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (reduction 'none')."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def df_loss(logp: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss. logp (..., 4, reg_max) log-probabilities,
    target (..., 4) continuous ltrb -> (...,) mean over the 4 sides."""
    reg_max = logp.shape[-1]
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.floor().long()
    tr = (tl + 1).clamp(0, reg_max - 1)
    wl = (tl + 1).to(target.dtype) - target
    wr = 1.0 - wl
    ce = -(logp.gather(-1, tl[..., None])[..., 0] * wl + logp.gather(-1, tr[..., None])[..., 0] * wr)
    return ce.mean(-1)


def detection_loss(feats: Sequence[torch.Tensor], gt_cls: torch.Tensor, gt_xywhn: torch.Tensor,
                   gt_mask: torch.Tensor, nc: int = 80, reg_max: int = 16, strides=(8, 16, 32),
                   box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5, tal_topk: int = 10,
                   tal_impl: Optional[str] = None):
    """feats: per-level raw maps (B, 4*reg_max + nc, H, W). Returns (total
    loss times B, LossMetrics of the three gained items, detached).
    `tal_impl` is passed to the assigner ("plain" forces its plain version).

    A YOLOv10 head's {"one2many": maps, "one2one": maps} gives the sum of
    the one-to-many loss at topk 10 and the one-to-one loss at topk 1 (two
    assignments), with the one-to-many items, as the JAX trainer does."""
    if isinstance(feats, dict):
        kw = dict(gt_cls=gt_cls, gt_xywhn=gt_xywhn, gt_mask=gt_mask, nc=nc, reg_max=reg_max, strides=strides,
                  box_gain=box_gain, cls_gain=cls_gain, dfl_gain=dfl_gain, tal_impl=tal_impl)
        many, items = detection_loss(feats["one2many"], tal_topk=10, **kw)
        one, _ = detection_loss(feats["one2one"], tal_topk=1, **kw)
        return many + one, items
    t = detect_terms(feats, gt_cls, gt_xywhn, gt_mask, nc, reg_max, strides, tal_topk, tal_impl)
    loss = torch.stack([t.loss_box * box_gain, t.loss_cls * cls_gain, t.loss_dfl * dfl_gain])
    return loss.sum() * feats[0].shape[0], LossMetrics(*loss.detach())


class DetectTerms(NamedTuple):
    """The three detect terms (before their gains) and what the seg loss reads of the assignment."""
    loss_box: torch.Tensor
    loss_cls: torch.Tensor
    loss_dfl: torch.Tensor
    assigned: object  # utils/tal.py's assignment
    weight: torch.Tensor  # (B, A) target score sum of each foreground anchor, 0 elsewhere
    imgsz: tuple  # the input's (h, w) in pixels


def detect_terms(feats: Sequence[torch.Tensor], gt_cls: torch.Tensor, gt_xywhn: torch.Tensor, gt_mask: torch.Tensor,
                 nc: int, reg_max: int, strides, tal_topk: int, tal_impl: Optional[str]) -> DetectTerms:
    """The assignment and the box, cls and DFL terms of detection_loss (feats: per-level raw maps)."""
    b = feats[0].shape[0]
    dev = feats[0].device
    shapes = [tuple(f.shape[2:]) for f in feats]
    flat = torch.cat([f.flatten(2) for f in feats], 2).float().transpose(1, 2)  # (B, A, no)
    pred_distri, pred_scores = flat.split((4 * reg_max, nc), -1)
    imgsz_h, imgsz_w = shapes[0][0] * strides[0], shapes[0][1] * strides[0]
    anchor_points, stride_tensor = make_anchors(shapes, strides, device=dev)  # (A, 2), (A, 1)

    # targets: normalised xywh -> pixel xyxy; a row counts if masked in and its box sum is positive
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], device=dev, dtype=torch.float32)
    gt_bboxes = xywh2xyxy(gt_xywhn.to(dev).float() * scale)
    mask_gt = (gt_mask.to(dev) > 0) & (gt_bboxes.sum(-1) > 0)
    gt_bboxes = gt_bboxes * mask_gt[..., None]
    gt_labels = (gt_cls.to(dev) * mask_gt).to(torch.int32)[..., None]

    # predicted boxes in grid units; one log_softmax serves the decode and the DFL
    pd_logp = F.log_softmax(pred_distri.reshape(b, -1, 4, reg_max), -1)
    dist = (pd_logp.exp() * torch.arange(reg_max, device=dev, dtype=torch.float32)).sum(-1)
    lt, rb = dist.chunk(2, -1)
    pred_bboxes = torch.cat((anchor_points - lt, anchor_points + rb), -1)  # (B, A, 4) xyxy

    with torch.no_grad():
        assigned = task_aligned_assign(
            pred_scores.sigmoid(), pred_bboxes * stride_tensor, anchor_points * stride_tensor, gt_labels,
            gt_bboxes, mask_gt[..., None].float(), topk=tal_topk, num_classes=nc, impl=tal_impl,
            grid=[(h, w, s) for (h, w), s in zip(shapes, strides)],
        )
    target_bboxes, target_scores, fg = assigned.target_bboxes, assigned.target_scores, assigned.fg_mask
    target_scores_sum = target_scores.sum().clamp(min=1.0)

    loss_cls = bce_with_logits(pred_scores, target_scores).sum() / target_scores_sum

    target_bboxes_g = target_bboxes / stride_tensor
    weight = target_scores.sum(-1) * fg
    iou = ciou_xyxy(pred_bboxes, target_bboxes_g)
    loss_box = (((1.0 - iou) * weight) * fg).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchor_points, target_bboxes_g, reg_max - 1)
    loss_dfl = (df_loss(pd_logp, target_ltrb) * weight * fg).sum() / target_scores_sum

    return DetectTerms(loss_box, loss_cls, loss_dfl, assigned, weight, (imgsz_h, imgsz_w))
