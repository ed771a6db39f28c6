"""Rotated-box math of the OBB task: probiou, corners, dist2rbox and the rotated candidate gate.

Counterpart of the JAX package's ops/rotated.py: boxes are xywhr (centre,
size, angle in radians) on the last dim, on any device, in the JAX
package's order of operations (squares as products, as jnp's integer
powers compute them).
"""

from __future__ import annotations

import math

import torch


def _covariance(boxes: torch.Tensor):
    """xywhr (..., 5) -> the Gaussian covariance terms (a, b, c) of each box."""
    a = boxes[..., 2] * boxes[..., 2] / 12.0
    b = boxes[..., 3] * boxes[..., 3] / 12.0
    r = boxes[..., 4]
    cos, sin = torch.cos(r), torch.sin(r)
    cos2, sin2 = cos * cos, sin * sin
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def gaussian_terms(boxes: torch.Tensor):
    """xywhr (..., 5) -> (x, y, a, b, c): each box's centre and covariance
    terms, what probiou reads of it (computed once where a box meets many)."""
    return (boxes[..., 0], boxes[..., 1], *_covariance(boxes))


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Probabilistic IoU (1 less the Hellinger distance of the boxes'
    Gaussians) of broadcastable xywhr boxes; with CIoU the aspect term of
    CIoU is taken off, its alpha detached."""
    iou = probiou_of_terms(gaussian_terms(obb1), gaussian_terms(obb2), eps)
    if CIoU:
        w1, h1 = obb1[..., 2], obb1[..., 3]
        w2, h2 = obb2[..., 2], obb2[..., 3]
        da = torch.atan(w2 / h2) - torch.atan(w1 / h1)
        v = (4 / math.pi**2) * (da * da)
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - v * alpha
    return iou


def probiou_of_terms(g1, g2, eps: float = 1e-7) -> torch.Tensor:
    """probiou from two boxes' gaussian_terms, broadcast."""
    x1, y1, a1, b1, c1 = g1
    x2, y2, a2, b2, c2 = g2
    sa, sb, sc = a1 + a2, b1 + b2, c1 + c2
    dy, dx = y1 - y2, x1 - x2
    denom = sa * sb - sc * sc + eps
    t1 = (sa * (dy * dy) + sb * (dx * dx)) / denom * 0.25
    t2 = (sc * (x2 - x1) * (y1 - y2)) / denom * 0.5
    det1 = (a1 * b1 - c1 * c1).clamp(min=0)
    det2 = (a2 * b2 - c2 * c2).clamp(min=0)
    t3 = torch.log((sa * sb - sc * sc) / (4 * torch.sqrt(det1 * det2) + eps) + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    return 1 - torch.sqrt(1.0 - torch.exp(-bd) + eps)


def xywhr2xyxyxyxy(boxes: torch.Tensor) -> torch.Tensor:
    """xywhr (..., 5) -> the 4 corners (..., 4, 2): centre + (w/2, h/2),
    + (w/2, -h/2), - (w/2, h/2), + (-w/2, h/2), each rotated by r."""
    c, s = torch.cos(boxes[..., 4]), torch.sin(boxes[..., 4])
    w2, h2 = boxes[..., 2] / 2, boxes[..., 3] / 2
    vx = torch.stack([w2 * c, w2 * s], -1)
    vy = torch.stack([-h2 * s, h2 * c], -1)
    ctr = boxes[..., :2]
    return torch.stack([ctr + vx + vy, ctr + vx - vy, ctr - vx - vy, ctr - vx + vy], -2)


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """ltrb distances (..., 4) and angles (..., 1) around anchor points
    (..., 2) -> the rotated boxes' centres and sizes (..., 4): the offset
    ((r - l) / 2, (b - t) / 2) rotated by the angle, added to the anchor;
    w = l + r, h = t + b. The angle stays apart."""
    lt, rb = pred_dist.chunk(2, -1)
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    half = (rb - lt) / 2
    xf, yf = half[..., 0:1], half[..., 1:2]
    x = xf * cos - yf * sin
    y = xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], -1) + anchor_points, lt + rb], -1)


def regularize_rboxes(rboxes: torch.Tensor) -> torch.Tensor:
    """xywhr (..., 5) in the canonical form w >= h, angle in [0, pi): where
    w <= h the sides swap and the angle turns by pi / 2."""
    x, y, w, h, t = rboxes.unbind(-1)
    swap = w > h
    w_ = torch.where(swap, w, h)
    h_ = torch.where(swap, h, w)
    t_ = torch.remainder(torch.where(swap, t, t + math.pi / 2), math.pi)
    return torch.stack([x, y, w_, h_, t_], -1)


def select_candidates_in_rotated_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor) -> torch.Tensor:
    """(A, 2) anchor points, (B, G, 5) xywhr boxes -> (B, G, A) bool: the
    anchor inside the rotated box, edges included (the projections of
    anchor - corner 0 on the two edges from corner 0 in [0, |edge|^2])."""
    corners = xywhr2xyxyxyxy(gt_bboxes)  # (B, G, 4, 2)
    a = corners[..., 0, :][..., None, :]  # (B, G, 1, 2)
    b = corners[..., 1, :][..., None, :]
    d = corners[..., 3, :][..., None, :]
    ab = b - a
    ad = d - a
    ap = xy_centers[None, None] - a  # (B, G, A, 2)
    norm_ab = (ab * ab).sum(-1)
    norm_ad = (ad * ad).sum(-1)
    ap_ab = (ap * ab).sum(-1)
    ap_ad = (ap * ad).sum(-1)
    return (ap_ab >= 0) & (ap_ab <= norm_ab) & (ap_ad >= 0) & (ap_ad <= norm_ad)


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, threshold: float = 0.45) -> torch.Tensor:
    """Fast NMS of (N, 5) xywhr boxes: by descending score (the lower index
    first among equal scores), a box is kept unless a higher-scored box
    overlaps it by probiou >= threshold (kept or not). Returns the kept
    indices into the input, in descending score."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=boxes.device)
    order = torch.argsort(-scores.float(), stable=True)
    sb = boxes.float()[order]
    ious = probiou(sb[:, None, :], sb[None, :, :]).triu(1)  # suppression by higher-scored boxes only
    keep = (ious >= threshold).sum(0) <= 0
    return order[keep]


def xyxyxyxy2xywhr(corners: torch.Tensor) -> torch.Tensor:
    """4 corners (..., 4, 2) of a rectangle -> xywhr (..., 5): the centre
    between corners 0 and 2, w = |c1 - c0|, h = |c2 - c1|, the angle of the
    first edge in [0, pi)."""
    a, b, c = corners[..., 0, :], corners[..., 1, :], corners[..., 2, :]
    e1 = b - a
    e2 = c - b
    w = torch.linalg.vector_norm(e1, dim=-1)
    h = torch.linalg.vector_norm(e2, dim=-1)
    r = torch.remainder(torch.atan2(e1[..., 1], e1[..., 0]), math.pi)
    return torch.cat([(a + c) / 2, torch.stack([w, h, r], -1)], -1)
