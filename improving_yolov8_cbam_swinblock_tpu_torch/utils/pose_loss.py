"""Pose loss: the detection loss plus the keypoints' OKS location and visibility terms, in fp32.

Counterpart of the JAX package's utils/pose_loss.py `pose_loss`. The box,
cls and DFL terms are detection_loss's (utils/loss.py detect_terms: the
task-aligned assigner at topk 10, the CUDA kernel on the card). Each
foreground anchor takes its assigned GT's keypoints: a gather on the
assignment's target_gt_idx, where the JAX package contracts a one-hot over
the GTs (one term per row there, so the two are equal). Its decoded
keypoints (raw x, y times 2 plus the anchor point less 0.5, in grid units)
meet the GT's (in pixels over the stride) in the OKS term
1 - exp(-d^2 / ((2 sigma)^2 (area + 1e-9) 2)) over the GT's visible points,
scaled by nk / visible points, with the target box's area in grid units
and the COCO sigmas at (17, 3), else 1 / nk; the visibility logits (nd 3)
meet the GT's visibility in a BCE. Both are averaged over the keypoints
and summed over the foreground anchors over their count. A GT point counts
as visible where its third column is not 0: the loader's targets always
carry one (at nd 2 the label parser's appended column); targets of two
columns count every point. Gains: box 7.5, pose 12, kobj 1, cls 0.5, dfl
1.5; the total is multiplied by the batch size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.anchors import make_anchors
from .loss import bce_with_logits, detect_terms
from .metrics import OKS_SIGMA


def pose_loss(feats: Sequence[torch.Tensor], pred_kpts: torch.Tensor, gt_cls: torch.Tensor, gt_xywhn: torch.Tensor,
              gt_mask: torch.Tensor, gt_kpts: torch.Tensor, nc: int = 80, kpt_shape=(17, 3), reg_max: int = 16,
              strides=(8, 16, 32), box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5,
              pose_gain: float = 12.0, kobj_gain: float = 1.0, tal_topk: int = 10, tal_impl: Optional[str] = None):
    """feats: the per-level raw maps (B, 4*reg_max + nc, H, W); pred_kpts
    the raw keypoints (B, A, nk * nd); gt_cls, gt_xywhn, gt_mask the padded
    targets; gt_kpts (B, G, nk, 3 or 2): x, y normalised to the input and
    the visibility. Returns (total loss times B, the (5,) gained items box,
    pose, kobj, cls, dfl, detached)."""
    b = feats[0].shape[0]
    nk, nd = kpt_shape
    dev = feats[0].device
    t = detect_terms(feats, gt_cls, gt_xywhn, gt_mask, nc, reg_max, strides, tal_topk, tal_impl)
    assigned, fg = t.assigned, t.assigned.fg_mask.float()
    imgsz_h, imgsz_w = t.imgsz
    anchor_points, stride_tensor = make_anchors([tuple(f.shape[2:]) for f in feats], strides, device=dev)

    pk = pred_kpts.float().reshape(b, -1, nk, nd)
    pk_xy = pk[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)  # grid units

    gt = gt_kpts.to(dev).float()
    kpx = gt[..., :2] * torch.tensor([imgsz_w, imgsz_h], dtype=torch.float32, device=dev)  # (B, G, nk, 2) pixels
    idx = assigned.target_gt_idx.long()[..., None, None]  # (B, A, 1, 1)
    sel_xy = kpx.gather(1, idx.expand(-1, -1, nk, 2)) / stride_tensor[None, :, None, :]
    if gt.shape[-1] > 2:
        kpt_mask = gt[..., 2].gather(1, idx[..., 0].expand(-1, -1, nk)) != 0  # (B, A, nk)
    else:
        kpt_mask = torch.ones(pk.shape[:3], dtype=torch.bool, device=dev)

    tb = assigned.target_bboxes / stride_tensor
    area = (tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])  # (B, A) grid units squared
    sig = OKS_SIGMA if (nk, nd) == (17, 3) else np.ones(nk) / nk
    sigmas = torch.as_tensor(sig, dtype=torch.float32, device=dev)
    d = (pk_xy[..., 0] - sel_xy[..., 0]) ** 2 + (pk_xy[..., 1] - sel_xy[..., 1]) ** 2  # (B, A, nk)
    e = d / ((2 * sigmas) ** 2 * (area[..., None] + 1e-9) * 2)
    factor = nk / (kpt_mask.sum(-1, keepdim=True) + 1e-9)
    per_el = factor * (1 - torch.exp(-e)) * kpt_mask
    n_fg = fg.sum().clamp(min=1.0)
    loss_kpt = (per_el.mean(-1) * fg).sum() / n_fg
    if nd == 3:
        loss_kobj = (bce_with_logits(pk[..., 2], kpt_mask.float()).mean(-1) * fg).sum() / n_fg
    else:
        loss_kobj = torch.zeros((), device=dev)

    loss = torch.stack([t.loss_box * box_gain, loss_kpt * pose_gain, loss_kobj * kobj_gain, t.loss_cls * cls_gain,
                        t.loss_dfl * dfl_gain])
    return loss.sum() * b, loss.detach()
