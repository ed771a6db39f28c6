"""Letterbox and the loader's sample transforms (counterparts of the JAX
package's data/augment.py: letterbox, format_sample, raw_train_transform,
val_transform).

The resize is PyTorch's bilinear interpolation with half-pixel centres
(align_corners=False), the rule cv2.INTER_LINEAR follows; cv2 rounds its
uint8 weights to fixed point, so pixels may differ from cv2's by a level or
two. The rect path's shrink (cv2.INTER_AREA in the JAX package) is
`area_resize`: each output pixel the mean of the input area it covers, with
fractional edge weights, as INTER_AREA computes it. The geometry (gain,
padding, ratio_pad, orig_shape) is computed exactly as in the JAX package.
The same code runs on the card (predict) and on CPU tensors in the loader's
worker threads; it needs no cv2.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def _resize(t: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    x = t.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=size_hw, mode="bilinear", align_corners=False)
    return x[0].round_().clamp_(0, 255).to(torch.uint8).permute(1, 2, 0)


def _area_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) weights of an area shrink along one axis: output i
    averages the input interval [i s, (i + 1) s), s = n_in / n_out, each
    input pixel weighted by its overlap with it."""
    s = n_in / n_out
    lo = torch.arange(n_out, dtype=torch.float64)[:, None] * s
    px = torch.arange(n_in, dtype=torch.float64)[None, :]
    overlap = (torch.minimum(px + 1, lo + s) - torch.maximum(px, lo)).clamp(min=0)
    return (overlap / overlap.sum(1, keepdim=True)).float()


def area_resize(t: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Shrink an (H, W, C) uint8 image to size_hw by area averaging."""
    wy = _area_weights(t.shape[0], size_hw[0]).to(t.device)
    wx = _area_weights(t.shape[1], size_hw[1]).to(t.device)
    y = torch.einsum("oh,hwc,pw->opc", wy, t.float(), wx)
    return y.round_().clamp_(0, 255).to(torch.uint8)


def letterbox(img: Union[np.ndarray, torch.Tensor], new_shape: Union[int, Tuple[int, int]], device=None,
              scaleup: bool = True) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Min-ratio resize and pad (grey 114) of an (H, W, 3) uint8 image, the
    pad split evenly on both sides. scaleup=False only shrinks. Returns
    (image (new_h, new_w, 3) uint8 on `device`, gain, (padw, padh) of the
    top-left pad)."""
    t = torch.as_tensor(img, device=device)
    shape = tuple(t.shape[:2])
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # (w, h)
    dw, dh = (new_shape[1] - new_unpad[0]) / 2, (new_shape[0] - new_unpad[1]) / 2
    if shape[::-1] != new_unpad:
        t = _resize(t, (new_unpad[1], new_unpad[0]))
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    t = F.pad(t.permute(2, 0, 1), (left, right, top, bottom), value=114).permute(1, 2, 0)
    return t, r, (left, top)


def format_sample(sample: Dict, imgsz: int, max_gt: int) -> Dict[str, np.ndarray]:
    """Fixed-shape sample: the image BGR -> RGB (HWC uint8), labels as
    normalised xywh padded to max_gt rows with a validity mask."""
    img = sample["img"]
    h, w = img.shape[:2]
    bboxes = sample["bboxes"]
    cls = sample["cls"]
    n = min(len(bboxes), max_gt)
    out_boxes = np.zeros((max_gt, 4), np.float32)
    out_cls = np.zeros((max_gt,), np.float32)
    out_mask = np.zeros((max_gt,), np.float32)
    if n:
        b = bboxes[:n]
        cx = (b[:, 0] + b[:, 2]) / 2 / w
        cy = (b[:, 1] + b[:, 3]) / 2 / h
        bw = (b[:, 2] - b[:, 0]) / w
        bh = (b[:, 3] - b[:, 1]) / h
        out_boxes[:n] = np.stack([cx, cy, bw, bh], axis=1)
        out_cls[:n] = cls[:n]
        out_mask[:n] = 1.0
    return {"img": img[..., ::-1].copy(), "cls": out_cls, "bboxes": out_boxes, "mask": out_mask}


def _shift_boxes(bboxes: np.ndarray, r: float, padw: int, padh: int) -> np.ndarray:
    b = bboxes.copy()
    if len(b):
        b = b * r
        b[:, [0, 2]] += padw
        b[:, [1, 3]] += padh
    return b.astype(np.float32)


def raw_train_transform(sample: Dict, imgsz: int, max_gt: int) -> Dict[str, np.ndarray]:
    """Host side of the device-augmented train path: letterbox only; mosaic,
    affine, HSV and flip run on the device inside the step."""
    img, r, (padw, padh) = letterbox(sample["img"], imgsz, scaleup=True)
    return format_sample({"img": img.numpy(), "bboxes": _shift_boxes(sample["bboxes"], r, padw, padh),
                          "cls": sample["cls"]}, imgsz, max_gt)


def val_transform(sample: Dict, imgsz: int, max_gt: int,
                  shape: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    """Val: letterbox only, never up. With a rect `shape` (h, w), the
    two-stage geometry: scale the longer side to imgsz (up bilinear, down by
    area), then letterbox without scaling up into `shape`. Adds ratio_pad
    (gain, padw, padh) and orig_shape (h, w)."""
    img0 = sample["img"]
    if shape is not None:
        h0, w0 = img0.shape[:2]
        r0 = imgsz / max(h0, w0)
        t = torch.as_tensor(img0)
        if r0 != 1.0:
            size = (min(math.ceil(h0 * r0), imgsz), min(math.ceil(w0 * r0), imgsz))
            t = _resize(t, size) if r0 > 1 else area_resize(t, size)
        img, r_lb, (padw, padh) = letterbox(t, shape, scaleup=False)
        r = r0 * r_lb
    else:
        img, r, (padw, padh) = letterbox(img0, imgsz, scaleup=False)
    out = format_sample({"img": img.numpy(), "bboxes": _shift_boxes(sample["bboxes"], r, padw, padh),
                         "cls": sample["cls"]}, imgsz, max_gt)
    out["ratio_pad"] = np.array([r, padw, padh], np.float32)
    out["orig_shape"] = np.array(img0.shape[:2], np.int32)
    return out
