"""Segmentation loss: the detection loss plus the prototype masks' BCE, in fp32.

Counterpart of the JAX package's utils/seg_loss.py `segmentation_loss`. The
box, cls and DFL terms are detection_loss's (utils/loss.py detect_terms: the
task-aligned assigner, the CUDA kernel on the card). The mask term: the
`max_masks` anchors of largest assignment weight (a stable descending sort,
so the lower anchor index first among equal weights, as jax.lax.top_k
orders them), each foreground one's mask logits coeffs @ protos against
its assigned instance's mask at the prototypes' resolution, BCE summed
inside its target box (scaled to the prototypes' grid) over the box area,
summed over the kept anchors and divided by the number of foreground
anchors. The instances' masks come from the overlap map (B, h, w), pixel =
instance index + 1, or from (B, P, h, w) int32 bit planes (instance j in
plane j // 32, bit j % 32); a map of another size than the prototypes'
(mask_ratio != 4) is resized to it by nearest neighbour as
jax.image.resize(method="nearest") samples it. Gains: box 7.5 on the box
and the mask terms, cls 0.5, dfl 1.5; the total is multiplied by the batch
size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .loss import bce_with_logits, detect_terms


def nearest_index(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """jax.image.resize's nearest source index of each of n_out outputs, in float32 as JAX computes it."""
    offsets = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(offsets).long().clamp(max=n_in - 1)


def segmentation_loss(feats: Sequence[torch.Tensor], mask_coeffs: torch.Tensor, protos: torch.Tensor,
                      gt_cls: torch.Tensor, gt_xywhn: torch.Tensor, gt_mask: torch.Tensor, seg_map: torch.Tensor,
                      nc: int = 80, reg_max: int = 16, strides=(8, 16, 32), box_gain: float = 7.5,
                      cls_gain: float = 0.5, dfl_gain: float = 1.5, tal_topk: int = 10, max_masks: int = 256,
                      tal_impl: Optional[str] = None):
    """feats: the per-level raw maps (B, 4*reg_max + nc, H, W); mask_coeffs
    (B, A, nm); protos (B, nm, h4, w4); gt_cls, gt_xywhn, gt_mask the padded
    targets; seg_map the overlap map (B, h, w) or the bit planes (B, P, h, w).
    Returns (total loss times B, the (4,) gained items box, seg, cls, dfl,
    detached)."""
    b = feats[0].shape[0]
    t = detect_terms(feats, gt_cls, gt_xywhn, gt_mask, nc, reg_max, strides, tal_topk, tal_impl)
    assigned, fg = t.assigned, t.assigned.fg_mask
    imgsz_h, imgsz_w = t.imgsz
    dev = protos.device
    nm, h4, w4 = protos.shape[1:]

    k = min(max_masks, t.weight.shape[1])
    sel_w, sel_idx = torch.sort(t.weight, dim=1, descending=True, stable=True)
    sel_w, sel_idx = sel_w[:, :k], sel_idx[:, :k]  # (B, K)
    sel_valid = fg.gather(1, sel_idx) & (sel_w > 0)
    sel_coeff = mask_coeffs.float().gather(1, sel_idx[..., None].expand(-1, -1, nm))
    sel_gtidx = assigned.target_gt_idx.long().gather(1, sel_idx)
    sel_boxes = assigned.target_bboxes.gather(1, sel_idx[..., None].expand(-1, -1, 4))  # image pixels
    pred_masks = torch.einsum("bkn,bnhw->bkhw", sel_coeff, protos.float())  # logits (B, K, h4, w4)

    seg_map = seg_map.to(dev)
    if tuple(seg_map.shape[-2:]) != (h4, w4):  # mask_ratio != 4
        seg_map = seg_map[..., nearest_index(seg_map.shape[-2], h4, dev), :][..., nearest_index(seg_map.shape[-1], w4, dev)]
    if seg_map.dim() == 4:  # bit planes: the instance's plane, then its bit
        plane = seg_map.gather(1, (sel_gtidx // 32)[..., None, None].expand(-1, -1, h4, w4))
        gt_masks = ((plane >> (sel_gtidx % 32).to(plane.dtype)[..., None, None]) & 1).float()
    else:
        gt_masks = (seg_map[:, None] == (sel_gtidx[..., None, None] + 1)).float()

    bce = bce_with_logits(pred_masks, gt_masks)  # (B, K, h4, w4)
    bx = sel_boxes * torch.tensor([w4 / imgsz_w, h4 / imgsz_h, w4 / imgsz_w, h4 / imgsz_h], dtype=torch.float32,
                                  device=dev)
    rows = torch.arange(h4, dtype=torch.float32, device=dev)[None, None, :, None]
    cols = torch.arange(w4, dtype=torch.float32, device=dev)[None, None, None, :]
    inbox = ((cols >= bx[..., 0, None, None]) & (cols < bx[..., 2, None, None]) & (rows >= bx[..., 1, None, None])
             & (rows < bx[..., 3, None, None]))
    area = ((bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1])).clamp(min=1.0)
    per_anchor = (bce * inbox).sum((-1, -2)) / area  # (B, K)
    loss_seg = (per_anchor * sel_valid).sum() / fg.sum().clamp(min=1).float()

    loss = torch.stack([t.loss_box * box_gain, loss_seg * box_gain, t.loss_cls * cls_gain, t.loss_dfl * dfl_gain])
    return loss.sum() * b, loss.detach()
