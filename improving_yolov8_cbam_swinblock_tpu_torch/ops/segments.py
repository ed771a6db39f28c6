"""Polygon and mask helpers (counterparts of the JAX package's ops/segments.py).

The polygon helpers are numpy, for the label pipeline and for the
polygons of predicted masks (masks2segments, with utils/patches.py
find_contours in cv2.findContours' place). The mask resizes
that the JAX package runs on the host with cv2.resize(INTER_LINEAR) run
here on the masks' own device (resize_bilinear, which the predictor's
native_masks uses): F.interpolate(mode="bilinear", align_corners=False,
antialias=False), the same half-pixel rule, in float, without cv2's
fixed-point rounding, and no antialiasing when it shrinks, as cv2's
INTER_LINEAR has none.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def segment2box(segment: np.ndarray, width: int = 640, height: int = 640) -> np.ndarray:
    """One (n, 2) polygon -> the xyxy box of its points inside the image (zeros if none is)."""
    x, y = segment.T
    keep = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    x, y = x[keep], y[keep]
    if not len(x):
        return np.zeros(4, segment.dtype)
    return np.array([x.min(), y.min(), x.max(), y.max()], segment.dtype)


def segments2boxes(segments: Sequence[np.ndarray]) -> np.ndarray:
    """Polygons -> (n, 4) centre xywh boxes, float32."""
    boxes = []
    for s in segments:
        x, y = np.asarray(s, np.float32).T
        boxes.append([x.min(), y.min(), x.max(), y.max()] if len(x) else [0, 0, 0, 0])
    b = np.asarray(boxes, np.float32).reshape(-1, 4)
    return np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], -1)


def resample_segments(segments: Sequence[np.ndarray], n: int = 1000) -> List[np.ndarray]:
    """Each closed polygon resampled to n points, linearly along its closed contour (float32)."""
    out = []
    for s in segments:
        s = np.asarray(s, np.float32)
        if len(s) == 0:
            out.append(np.zeros((n, 2), np.float32))
            continue
        s = np.concatenate([s, s[0:1]], axis=0)  # close the ring
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out.append(np.stack([np.interp(x, xp, s[:, i]) for i in range(2)], -1).astype(np.float32))
    return out


def resize_bilinear(t: torch.Tensor, size) -> torch.Tensor:
    """(n, h, w) float -> (n, *size): cv2.resize(INTER_LINEAR)'s geometry, in float."""
    return F.interpolate(t[None].float(), size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)[0]


def masks2segments(masks: np.ndarray, strategy: str = "all") -> List[np.ndarray]:
    """(n, h, w) binary masks -> one (k, 2) float32 polygon each, in mask
    pixels: every outer contour (find_contours, in cv2's order)
    concatenated, or with 'largest' the one of largest area (contour_area; the
    first of equal areas); (0, 2) for an empty mask. The JAX package's
    ops/segments.py masks2segments."""
    from ..utils.patches import contour_area, find_contours

    out = []
    for m in np.asarray(masks):
        cnts = find_contours(m)
        if not cnts:
            c = np.zeros((0, 2), np.float32)
        elif strategy == "largest":
            c = cnts[int(np.argmax([contour_area(x) for x in cnts]))]
        else:
            c = np.concatenate(cnts)
        out.append(c.astype(np.float32))
    return out
