"""Anchor-free grid math: anchor points, dist -> bbox, DFL decode.

Channel-first counterparts of the JAX package's ops/anchors.py: boxes and
distances carry their 4 coordinates on dim 1, anchors on the last dim.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell centres of every level, row-major: anchor points (A, 2) as (x, y)
    in grid units and per-anchor strides (A, 1), fp32."""
    points, stride_list = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, device=device, dtype=torch.float32) + 0.5
        sy = torch.arange(h, device=device, dtype=torch.float32) + 0.5
        sy, sx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack((sx, sy), -1).reshape(-1, 2))
        stride_list.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(points), torch.cat(stride_list)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """(B, 4, A) ltrb distances -> (B, 4, A) xywh (or xyxy) boxes around (1, 2, A) anchor points."""
    lt, rb = distance.chunk(2, 1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    return torch.cat(((x1y1 + x2y2) / 2, x2y2 - x1y1) if xywh else (x1y1, x2y2), 1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """(..., 4) xyxy boxes around (..., 2) anchor points -> ltrb distances
    clamped to [0, reg_max - 0.01], coordinates on the last dim."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat((anchor_points - x1y1, x2y2 - anchor_points), -1).clamp(0, reg_max - 0.01)


def dfl_decode(pred_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(B, 4*reg_max, A) logits laid out (4, reg_max) -> (B, 4, A) expected
    distances: softmax over the bins dotted with arange(reg_max)."""
    b, _, a = pred_dist.shape
    x = pred_dist.view(b, 4, reg_max, a).softmax(2)
    proj = torch.arange(reg_max, device=x.device, dtype=x.dtype).view(1, 1, reg_max, 1)
    return (x * proj).sum(2)
