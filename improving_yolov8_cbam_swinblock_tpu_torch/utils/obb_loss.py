"""OBB loss: the rotated task-aligned assignment, the probiou box loss, BCE and DFL, in fp32.

Counterpart of the JAX package's utils/obb_loss.py `rotated_task_aligned_assign`
and `obb_loss`. The rotated assigner is plain PyTorch, as the JAX package's
is plain JAX (no Pallas kernel): dense (B, G, A) tensors, the candidates
gated by the rotated rectangle (ops/rotated.py
select_candidates_in_rotated_gts), probiou overlaps, align = score^0.5 *
overlap^6, the top-k per GT by iterative first-index argmax (never
torch.topk, whose order among ties is not fixed), conflicts resolved by
the highest overlap over all GTs (utils/tal.py select_highest_overlaps),
exact gathers and the normalisation of utils/tal.py. The loss decodes each
anchor's rotated box with dist2rbox and the head's angle, drops GT boxes
with a side under 2 pixels, and sums box (1 - probiou), cls (BCE) and DFL
(on the target box's axis-aligned xyxy) terms over the target score sum;
gains 7.5 / 0.5 / 1.5, the total times the batch size. The loss equals
JAX's; its gradient too, but where JAX's is NaN: a background anchor
meets its own box in the probiou term, not an empty GT row (JAX's sqrt of
a zero determinant has an infinite derivative, which the zero weight turns
into NaN, so one image without GT, or whose first box is under 2 px,
makes a step's every gradient NaN). No matrix product computes it, so
TF32 plays no part.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops.anchors import bbox2dist, make_anchors
from ..ops.boxes import xywh2xyxy
from ..ops.rotated import dist2rbox, probiou, select_candidates_in_rotated_gts
from .loss import LossMetrics, bce_with_logits, df_loss
from .tal import ALPHA, BETA, TALResult, select_highest_overlaps


def rotated_task_aligned_assign(pd_scores, pd_bboxes_r, anc_points, gt_labels, gt_bboxes_r, mask_gt, topk: int = 10,
                                num_classes: int = 80, alpha: float = ALPHA, beta: float = BETA,
                                eps: float = 1e-9) -> TALResult:
    """pd_scores (B, A, nc) sigmoid scores, pd_bboxes_r (B, A, 5) xywhr
    pixels, anc_points (A, 2) pixels, gt_labels (B, G, 1), gt_bboxes_r
    (B, G, 5) xywhr pixels, mask_gt (B, G, 1) 0/1 -> TALResult (its
    target_bboxes (B, A, 5) xywhr), in fp32."""
    b, a, nc = pd_scores.shape
    g = gt_bboxes_r.shape[1]
    scores, pbox, gbox = pd_scores.float(), pd_bboxes_r.float(), gt_bboxes_r.float()
    gt_cls = gt_labels[..., 0].long().clamp(0, nc - 1)  # (B, G)
    mask_in = select_candidates_in_rotated_gts(anc_points.float(), gbox)  # (B, G, A)
    cand = mask_in & (mask_gt[..., 0] > 0)[..., None]
    candf = cand.float()

    bbox_scores = torch.gather(scores.transpose(1, 2), 1, gt_cls[..., None].expand(b, g, a)) * candf
    overlaps = probiou(gbox[:, :, None, :], pbox[:, None, :, :]).clamp(min=0) * candf
    if (alpha, beta) == (ALPHA, BETA):
        o2 = overlaps * overlaps
        align = torch.sqrt(bbox_scores) * (o2 * o2 * o2)
    else:
        align = bbox_scores.pow(alpha) * overlaps.pow(beta)

    live = align.clone()  # top-k per GT: iterative argmax, the first index wins ties
    mask_topk = torch.zeros_like(cand)
    for _ in range(min(topk, a)):
        hit = live.argmax(-1, keepdim=True)
        mask_topk.scatter_(-1, hit, True)
        live.scatter_(-1, hit, float("-inf"))
    tgt_idx, fg, mask_pos = select_highest_overlaps(mask_topk & cand, overlaps)

    labels = torch.gather(gt_cls, 1, tgt_idx)
    boxes = torch.gather(gbox, 1, tgt_idx[..., None].expand(b, a, 5))
    align_pos = align * mask_pos
    pos_align = align_pos.amax(-1, keepdim=True)  # (B, G, 1)
    pos_ovl = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_pos * pos_ovl / (pos_align + eps)).amax(1)  # (B, A)
    tscores = F.one_hot(labels, num_classes).float() * fg[..., None] * norm[..., None]
    return TALResult(labels.to(torch.int32), boxes, tscores, fg, tgt_idx.to(torch.int32))


def obb_loss(feats: Sequence[torch.Tensor], pred_angle: torch.Tensor, gt_cls: torch.Tensor, gt_xywhrn: torch.Tensor,
             gt_mask: torch.Tensor, nc: int = 80, reg_max: int = 16, strides=(8, 16, 32), box_gain: float = 7.5,
             cls_gain: float = 0.5, dfl_gain: float = 1.5, tal_topk: int = 10):
    """feats: the per-level raw maps (B, 4*reg_max + nc, H, W); pred_angle
    the head's angles (B, A, 1) in radians; gt_cls (B, G), gt_xywhrn (B, G,
    5) x, y, w, h normalised to the input and the angle, gt_mask (B, G).
    Returns (total loss times B, LossMetrics of the three gained items,
    detached)."""
    b = feats[0].shape[0]
    dev = feats[0].device
    shapes = [tuple(f.shape[2:]) for f in feats]
    flat = torch.cat([f.flatten(2) for f in feats], 2).float().transpose(1, 2)  # (B, A, no)
    pred_distri, pred_scores = flat.split((4 * reg_max, nc), -1)
    angle = pred_angle.float()
    imgsz_h, imgsz_w = shapes[0][0] * strides[0], shapes[0][1] * strides[0]
    anchor_points, stride_tensor = make_anchors(shapes, strides, device=dev)  # (A, 2), (A, 1)

    # targets in pixels; a box with a side under 2 pixels is dropped, as the reference drops it
    gt = gt_xywhrn.to(dev).float()
    scale_wh = torch.tensor([imgsz_w, imgsz_h], dtype=torch.float32, device=dev)
    wh_px = gt[..., 2:4] * scale_wh
    valid = (gt_mask.to(dev) > 0) & (wh_px >= 2.0).all(-1)
    gt_r = torch.cat([gt[..., :2] * scale_wh, wh_px, gt[..., 4:5]], -1) * valid[..., None]
    gt_labels = (gt_cls.to(dev) * valid).to(torch.int32)[..., None]

    pd_logp = F.log_softmax(pred_distri.reshape(b, -1, 4, reg_max), -1)  # one serves the decode and the DFL
    dist = (pd_logp.exp() * torch.arange(reg_max, device=dev, dtype=torch.float32)).sum(-1)
    pred_r = torch.cat([dist2rbox(dist, angle, anchor_points[None]), angle], -1)  # (B, A, 5) grid units

    with torch.no_grad():
        assigned = rotated_task_aligned_assign(
            pred_scores.sigmoid(), torch.cat([pred_r[..., :4] * stride_tensor, pred_r[..., 4:5]], -1),
            anchor_points * stride_tensor, gt_labels, gt_r, valid[..., None].float(), topk=tal_topk,
            num_classes=nc)
    tgt_scores, fg = assigned.target_scores, assigned.fg_mask
    tss = tgt_scores.sum().clamp(min=1.0)

    loss_cls = bce_with_logits(pred_scores, tgt_scores).sum() / tss
    tb = torch.cat([assigned.target_bboxes[..., :4] / stride_tensor, assigned.target_bboxes[..., 4:5]], -1)
    weight = tgt_scores.sum(-1) * fg
    # a background anchor's target is GT 0 of its image, all zeros where that row is empty: probiou's sqrt then has
    # an infinite derivative, which times the zero weight gives NaN (JAX's obb_loss does so); such anchors meet
    # their own box instead, so that their term is 0 with a zero gradient, as the reference's foreground-only sum
    safe_tb = torch.where(fg[..., None], tb, pred_r.detach())
    loss_box = (((1.0 - probiou(pred_r, safe_tb)) * weight) * fg).sum() / tss
    target_ltrb = bbox2dist(anchor_points, xywh2xyxy(tb[..., :4]), reg_max - 1)
    loss_dfl = (df_loss(pd_logp, target_ltrb) * weight * fg).sum() / tss

    loss = torch.stack([loss_box * box_gain, loss_cls * cls_gain, loss_dfl * dfl_gain])
    return loss.sum() * b, LossMetrics(*loss.detach())
