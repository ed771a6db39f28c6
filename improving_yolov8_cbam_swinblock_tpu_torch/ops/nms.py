"""Batched greedy NMS, axis-aligned or rotated boxes.

Same contract as the JAX package's `non_max_suppression`: the top
`MAX_NMS` anchors by confidence (stable order: the lower index first among
equal scores) or, with `multi_label` and nc > 1, the top `MAX_NMS`
(anchor, class) pairs by score (the lower flat index anchor * nc + class
first among equal scores), then exact greedy suppression truncated at
`max_det` picks, one image per row of the batch, classes kept apart by a
coordinate offset (class-aware) or not (`agnostic`: one box of any class
suppresses the others).
Output (B, max_det, 6 + ne) rows x1, y1, x2, y2, conf, cls, then the ne
columns the prediction carries after its class scores (a Segment head's
mask coefficients), taken from each kept anchor; rows with conf 0 are
padding. With `rotated` (an OBB head's prediction: xywh of the rotated
boxes, class scores, then the angle) the boxes stay xywh, the class offset
moves the centres only, and a pick suppresses the candidates whose probiou
with it exceeds iou_thres (the JAX package's rotated branch, its
ops/nms.py:98-139): rows x, y, w, h, conf, cls, angle.
"""

from __future__ import annotations

import torch

from .boxes import xywh2xyxy
from .rotated import gaussian_terms, probiou_of_terms

MAX_WH = 7680.0  # class offset: boxes of different classes never overlap
MAX_NMS = 4096  # candidates per image that enter suppression


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        max_det: int = 300, nc: int = 80, multi_label: bool = False,
                        agnostic: bool = False, rotated: bool = False) -> torch.Tensor:
    """prediction (B, 4 + nc + ne, A): xywh boxes, class scores, then ne extra
    columns (rotated: the angle first)."""
    pred = prediction.transpose(1, 2).float()  # (B, A, 4+nc+ne)
    boxes = pred[..., :4] if rotated else xywh2xyxy(pred[..., :4])
    b, a = pred.shape[:2]
    ne = pred.shape[2] - 4 - nc
    if multi_label and nc > 1:  # every (anchor, class) pair is a candidate
        k = min(MAX_NMS, a * nc)
        top, flat = torch.sort(pred[..., 4:4 + nc].reshape(b, a * nc), dim=1, descending=True, stable=True)
        top, flat = top[:, :k], flat[:, :k]
        idx, cls_k = flat // nc, (flat % nc).float()
    else:
        conf, cls = pred[..., 4:4 + nc].max(-1)  # max returns the first index among ties
        k = min(MAX_NMS, a)
        top, idx = torch.sort(conf, dim=1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        cls_k = cls.gather(1, idx).float()
    cand = boxes.gather(1, idx[..., None].expand(b, k, 4))
    cand_extra = pred[..., 4 + nc:].gather(1, idx[..., None].expand(b, k, ne))
    live = torch.where(top > conf_thres, top, torch.full_like(top, -1.0))
    shift = (cls_k * (0.0 if agnostic else MAX_WH))[..., None]
    rows = torch.arange(b, device=pred.device)
    cols = torch.arange(k, device=pred.device)
    if rotated:  # the class offset moves the centres only; the angle is the first extra column
        rb = torch.cat([cand[..., :2] + shift, cand[..., 2:], cand_extra[..., :1]], -1)  # (B, K, 5) xywhr
        terms = gaussian_terms(rb)  # once: each pick meets every candidate
    else:
        x1, y1, x2, y2 = (cand + shift).unbind(-1)
        areas = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    out = torch.zeros(b, max_det, 6 + ne, device=pred.device)
    for i in range(max_det):
        best = live.argmax(1)  # first index among ties
        best_score = live[rows, best]
        valid = best_score > 0.0
        if rotated:
            iou = probiou_of_terms(terms, [t[rows, best][:, None] for t in terms])
        else:
            bx1, by1, bx2, by2 = (t[rows, best, None] for t in (x1, y1, x2, y2))
            inter = (torch.minimum(x2, bx2) - torch.maximum(x1, bx1)).clamp(min=0) * (
                torch.minimum(y2, by2) - torch.maximum(y1, by1)).clamp(min=0)
            iou = inter / (areas + areas[rows, best, None] - inter + 1e-7)
        row = torch.cat([cand[rows, best], best_score[:, None], cls_k[rows, best, None], cand_extra[rows, best]], -1)
        out[:, i] = torch.where(valid[:, None], row, torch.zeros_like(row))
        done = (iou > iou_thres) | (cols == best[:, None]) | ~valid[:, None]
        live = live.masked_fill(done, -1.0)
        if i % 16 == 15 and not bool((live > 0).any()):  # every later row is padding
            break
    return out


def _topk_first(t: torch.Tensor, k: int):
    """The k largest values along dim 1 and their indices, the lower index
    first among equal values (as jax.lax.top_k orders them; torch.topk
    promises no order among ties)."""
    v, i = torch.sort(t, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def e2e_postprocess(prediction: torch.Tensor, max_det: int = 300, nc: int = 80) -> torch.Tensor:
    """NMS-free top-k of the JAX package's e2e_postprocess (its ops/nms.py:76-95):
    the top min(max_det, A) anchors by their best class score, then the top
    of those (anchor, class) pairs by score -> (B, k, 6) rows of the four box
    values as the prediction holds them (the Detect head's xywh), score,
    class. No box suppresses another."""
    p = prediction.transpose(1, 2).float()  # (B, A, 4+nc)
    boxes, scores = p[..., :4], p[..., 4:4 + nc]
    b, a = boxes.shape[:2]
    k = min(max_det, a)
    _, idx = _topk_first(scores.amax(-1), k)
    boxes_k = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    scores_k = scores.gather(1, idx[..., None].expand(-1, -1, nc))
    top2, idx2 = _topk_first(scores_k.reshape(b, k * nc), k)
    out_boxes = boxes_k.gather(1, (idx2 // nc)[..., None].expand(-1, -1, 4))
    return torch.cat([out_boxes, top2[..., None], (idx2 % nc).float()[..., None]], -1)
