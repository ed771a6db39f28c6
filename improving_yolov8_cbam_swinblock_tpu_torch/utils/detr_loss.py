"""RT-DETR's loss: Hungarian matching, then varifocal (or focal) class loss, L1 and GIoU.

Counterpart of the JAX package's utils/detr_loss.py, all of it in fp32:

  * the GT comes dense-padded (B, G) with a mask, as the detect losses take
    it; padded GT columns cost a constant 1e6 in the matching, so they never
    move the real columns' assignment, and every reduction masks them out;
  * the cost matrices of every supervised layer (the encoder's top-k and
    each decoder layer) are built on the model's device, copied to the host
    once, solved there one by one by scipy's linear_sum_assignment, and the
    query indices copied back once (`hungarian_assign`). Costs that differ
    from the JAX package's in the last bit can flip a near tie, so a
    comparison with it holds the assignment, not only the loss;
  * the denoising group needs no matching: positive denoising query
    g * G + j is GT slot j by construction (nn/transformer.py
    get_cdn_group), an identity match over the tiled GT slots.

The loss is a sum over layers without a batch scale; the train step logs
(giou, cls, l1) of the last matched layer, the reference's loss names.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .loss import bce_with_logits

BIG = 1.0e6  # the matching cost of a padded GT column


def iou_xywh(box1: torch.Tensor, box2: torch.Tensor, giou: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise (broadcasting) IoU, or GIoU, of (..., 4) centre-xywh boxes
    -> (...), with the JAX package's bbox_iou eps placement."""
    (x1, y1, w1, h1), (x2, y2, w2, h2) = box1.unbind(-1), box2.unbind(-1)
    b1x1, b1x2, b1y1, b1y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
    b2x1, b2x2, b2y1, b2y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not giou:
        return iou
    c_area = (torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)) * (
        torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)) + eps
    return iou - (c_area - union) / c_area


def match_costs(pred_bboxes, pred_scores, gt_bboxes, gt_cls, gt_mask) -> torch.Tensor:
    """(..., nq, G) fp32 matching costs: 2 x the focal class cost (alpha
    0.25, gamma 2) at each GT's class + 5 x L1 + 2 x (1 - GIoU); non-finite
    costs 0, padded GT columns BIG. pred_bboxes (..., nq, 4) sigmoid xywh,
    pred_scores (..., nq, nc) logits, gt (B, G, ...) broadcast over the
    leading dims."""
    pb = pred_bboxes.detach().float()
    pr = torch.sigmoid(pred_scores.detach().float())
    idx = gt_cls.long()[..., None, :].expand(*pr.shape[:-1], gt_cls.shape[-1])
    sc = pr.gather(-1, idx)
    cost_class = 0.25 * (1.0 - sc) ** 2 * (-torch.log(sc + 1e-8)) - 0.75 * sc ** 2 * (-torch.log(1.0 - sc + 1e-8))
    gt = gt_bboxes.float()[..., None, :, :]
    cost_bbox = (pb[..., :, None, :] - gt).abs().sum(-1)
    giou = iou_xywh(pb[..., :, None, :], gt, giou=True)
    cost = 2.0 * cost_class + 5.0 * cost_bbox + 2.0 * (1.0 - giou)
    cost = torch.where(torch.isfinite(cost), cost, torch.zeros_like(cost))
    return torch.where(gt_mask[..., None, :] > 0, cost, torch.full_like(cost, BIG))


def assign_host(cost: np.ndarray) -> np.ndarray:
    """(N, nq, G) costs -> (N, G) int64: the query each GT column is assigned
    (scipy's linear_sum_assignment per matrix; 0 for a column left over
    where G > nq, as the JAX package leaves it)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost, np.float64)
    out = np.zeros((cost.shape[0], cost.shape[2]), np.int64)
    for i in range(cost.shape[0]):
        rows, cols = linear_sum_assignment(cost[i])
        out[i, cols] = rows
    return out


def hungarian_assign(pred_bboxes, pred_scores, gt_bboxes, gt_cls, gt_mask) -> torch.Tensor:
    """(..., G) int64 on the predictions' device: the query assigned to each
    GT slot of each leading index, from match_costs, with one copy of the
    costs to the host and one of the indices back."""
    cost = match_costs(pred_bboxes, pred_scores, gt_bboxes, gt_cls, gt_mask)
    lead = cost.shape[:-2]
    q = assign_host(cost.reshape(-1, *cost.shape[-2:]).cpu().numpy())
    return torch.from_numpy(q).to(cost.device).reshape(*lead, cost.shape[-1])


def layer_losses(pb, ps, gt_bboxes, gt_cls, gt_mask, q_idx, nc: int):
    """Each of L supervised layers' (class, 5 x L1, 2 x GIoU) losses, each
    (L,): pb (L, B, nq, 4) sigmoid xywh, ps (L, B, nq, nc) logits, gt (B, G,
    ...), q_idx (L, B, G) the query of each GT slot. The class loss is the
    varifocal loss (alpha 0.75, gamma 2) on the matched IoUs where there is
    a GT, else the focal loss (gamma 1.5, alpha 0.25), each
    the mean over queries summed over images and classes, times nq / the GT
    count; L1 and GIoU are summed over the real GT slots over their count."""
    L, b, nq, _ = ps.shape
    ps, pb = ps.float(), pb.float()
    gt_bboxes = gt_bboxes.float()
    valid = gt_mask > 0
    num_gts = valid.sum().float().clamp(min=1.0)
    pa = pb.gather(2, q_idx[..., None].expand(-1, -1, -1, 4))  # (L, B, G, 4) the matched predictions
    tcls = torch.where(valid, gt_cls.long(), torch.full_like(gt_cls.long(), nc)).expand(L, -1, -1)
    target = torch.full((L, b, nq), nc, dtype=torch.long, device=ps.device).scatter(2, q_idx, tcls)
    one_hot = F.one_hot(target, nc + 1)[..., :nc].float()
    iou = torch.where(valid, iou_xywh(pa.detach(), gt_bboxes), torch.zeros((), device=ps.device))
    gt_scores = torch.zeros((L, b, nq), device=ps.device).scatter(2, q_idx, iou)[..., None] * one_hot
    pr = torch.sigmoid(ps)
    bce = bce_with_logits(ps, one_hot)
    w = 0.75 * pr ** 2 * (1.0 - one_hot) + gt_scores * one_hot
    vfl = (bce_with_logits(ps, gt_scores) * w).mean(2).sum((1, 2))
    p_t = one_hot * pr + (1.0 - one_hot) * (1.0 - pr)
    fl = (bce * (1.0 - p_t) ** 1.5 * (one_hot * 0.25 + (1.0 - one_hot) * 0.75)).mean(2).sum((1, 2))
    cls = torch.where(valid.any(), vfl, fl)
    cls = cls * nq / num_gts
    l1 = ((pa - gt_bboxes).abs() * valid[..., None]).sum((1, 2, 3)) / num_gts
    giou = ((1.0 - iou_xywh(pa, gt_bboxes, giou=True)) * valid).sum((1, 2)) / num_gts
    return cls, 5.0 * l1, 2.0 * giou


def detr_layers_loss(pred_bboxes, pred_scores, gt_cls, gt_xywhn, gt_mask, nc: int,
                     q_idx: Optional[torch.Tensor] = None):
    """Hungarian-matched (class, L1, GIoU) losses of L stacked layers, each
    (L,): pred_* (L, B, nq, 4 or nc), GT (B, G, ...). q_idx (L, B, G)
    replaces the matching where given (a check hands in another matcher's)."""
    if q_idx is None:
        q_idx = hungarian_assign(pred_bboxes, pred_scores, gt_xywhn, gt_cls, gt_mask)
    return layer_losses(pred_bboxes, pred_scores, gt_xywhn, gt_cls, gt_mask, q_idx, nc)


def rtdetr_loss(preds: Dict[str, torch.Tensor], gt_cls, gt_xywhn, gt_mask, nc: int, num_dn: int = 0,
                q_idx: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The RT-DETR train loss of the head's train dict (nn/transformer.py
    RTDETRDecoder): the encoder's top-k and the decoder layers' last nq
    queries Hungarian-matched to the GT (gt_cls (B, G), gt_xywhn (B, G, 4)
    normalised, gt_mask (B, G); a slot whose box sums to 0 is padding), and
    the first num_dn queries of each decoder layer identity-matched to the
    tiled GT slots. Returns (total, (giou, cls, l1) of the last decoder
    layer). q_idx (1 + ndl, B, G) replaces the matching where given."""
    dec_b, dec_s = preds["dec_bboxes"], preds["dec_scores"]
    gt_cls = gt_cls.long()
    gt_xywhn = gt_xywhn.float()
    gt_mask = (gt_mask > 0) & (gt_xywhn.sum(-1) > 0)
    main_b = torch.cat([preds["enc_bboxes"][None], dec_b[:, :, num_dn:]], 0)
    main_s = torch.cat([preds["enc_scores"][None], dec_s[:, :, num_dn:]], 0)
    cls_l, l1_l, giou_l = detr_layers_loss(main_b, main_s, gt_cls, gt_xywhn, gt_mask, nc, q_idx)
    total = cls_l.sum() + l1_l.sum() + giou_l.sum()
    items = (giou_l[-1], cls_l[-1], l1_l[-1])
    if num_dn > 0:
        g = gt_cls.shape[1]
        cap = min(g, max(num_dn // 2, 1))
        ng = num_dn // (2 * cap)
        q_dn = torch.arange(ng * cap, device=dec_b.device).expand(dec_b.shape[0], gt_cls.shape[0], -1)
        dn = layer_losses(dec_b[:, :, :num_dn], dec_s[:, :, :num_dn], gt_xywhn[:, :cap].repeat(1, ng, 1),
                          gt_cls[:, :cap].repeat(1, ng), gt_mask[:, :cap].repeat(1, ng), q_dn, nc)
        total = total + sum(t.sum() for t in dn)
    return total, items
