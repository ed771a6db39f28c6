"""Box and mask geometry for the predict, val and train paths (counterparts of the JAX package's ops/boxes.py)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

CIOU_EPS = 1e-7
CIOU_V = 4.0 / math.pi**2


def ciou_xyxy(b1: torch.Tensor, b2: torch.Tensor, atan1: torch.Tensor = None, atan2: torch.Tensor = None,
              eps: float = CIOU_EPS) -> torch.Tensor:
    """Complete IoU of xyxy boxes on the last dim, broadcasting, without the
    last axis. h gets +eps before the ratio, w does not, as in the JAX
    package's bbox_iou(xywh=False, CIoU=True). The aspect term's alpha is
    detached. atan1/atan2 may hand in atan(w/h) of each box, computed once
    per box; otherwise they are computed here."""
    b1x1, b1y1, b1x2, b1y2 = b1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = b2.unbind(-1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) * \
        (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw * cw + ch * ch + eps
    dx = b2x1 + b2x2 - b1x1 - b1x2
    dy = b2y1 + b2y2 - b1y1 - b1y2
    rho2 = (dx * dx + dy * dy) / 4
    a1 = torch.atan(w1 / h1) if atan1 is None else atan1
    a2 = torch.atan(w2 / h2) if atan2 is None else atan2
    da = a2 - a1
    v = CIOU_V * (da * da)
    with torch.no_grad():
        alpha = v / (v - iou + (1.0 + eps))
    return iou - (rho2 / c2 + v * alpha)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the last dim."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], -1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h) on the last dim."""
    lt, rb = x[..., :2], x[..., 2:4]
    return torch.cat([(lt + rb) * 0.5, rb - lt], -1)


def detr_rows(y: torch.Tensor, wh: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """RT-DETR's eval output (B, nq, 4 + nc), sigmoid xywh then the class
    scores -> (B, nq, 6) fp32 rows (x1, y1, x2, y2, best score, its class),
    in query order. wh (w, h) scales the normalised xywh before the
    conversion (val's input pixels); without it the boxes stay normalised
    (predict scales them by each original frame)."""
    y = y.float()
    score, cls = y[..., 4:].max(-1)
    box = y[..., :4]
    if wh is not None:
        box = box * torch.tensor([*wh, *wh], dtype=torch.float32, device=y.device)
    return torch.cat([xywh2xyxy(box), score[..., None], cls[..., None].float()], -1)


def clip_boxes(boxes: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to an image of shape (h, w)."""
    h, w = shape
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], -1)


def scale_boxes(img1_shape: Tuple[int, int], boxes: torch.Tensor, img0_shape: Tuple[int, int]) -> torch.Tensor:
    """Map xyxy boxes from the letterboxed img1_shape back to img0_shape
    (min-ratio gain, centred pad) and clip them to it."""
    gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
    pad_w = round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1)
    pad_h = round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1)
    boxes = boxes - torch.tensor([pad_w, pad_h, pad_w, pad_h], dtype=boxes.dtype, device=boxes.device)
    return clip_boxes(boxes / gain, img0_shape)


def clip_coords(coords: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Points (..., 2 or more) with x clipped to [0, w] and y to [0, h] of an
    image of shape (h, w); the columns after y pass through."""
    h, w = shape
    xy = torch.stack([coords[..., 0].clamp(0, w), coords[..., 1].clamp(0, h)], -1)
    return torch.cat([xy, coords[..., 2:]], -1)


def scale_coords(img1_shape: Tuple[int, int], coords: torch.Tensor, img0_shape: Tuple[int, int],
                 ratio_pad=None, normalize: bool = False, padding: bool = True) -> torch.Tensor:
    """Points (..., 2 or more) from the letterboxed img1_shape back to
    img0_shape: less the pad (with `padding`), over the gain, clipped to the
    image (clip_coords), and with `normalize` divided by its width and
    height. ratio_pad ((gain, gain), (pad_w, pad_h)) gives the letterbox's
    own gain and pad (the predictor's integer pad); without it they are
    computed from the shapes, the pad unrounded. The JAX package's
    ops/boxes.py scale_coords."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad_w = (img1_shape[1] - img0_shape[1] * gain) / 2
        pad_h = (img1_shape[0] - img0_shape[0] * gain) / 2
    else:
        gain = ratio_pad[0][0]
        pad_w, pad_h = ratio_pad[1]
    xy = coords[..., :2]
    if padding:
        xy = xy - torch.tensor([pad_w, pad_h], dtype=coords.dtype, device=coords.device)
    gain = torch.tensor(gain, dtype=coords.dtype, device=coords.device)  # a true division on every device
    out = clip_coords(torch.cat([xy / gain, coords[..., 2:]], -1), img0_shape)
    if normalize:
        out = torch.cat([out[..., :2] / torch.tensor([img0_shape[1], img0_shape[0]], dtype=out.dtype,
                                                      device=out.device), out[..., 2:]], -1)
    return out


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """masks (n, h, w) with every pixel outside its xyxy box (n, 4, in mask
    pixels) zeroed: a pixel (row, col) is inside where x1 <= col < x2 and
    y1 <= row < y2."""
    _, h, w = masks.shape
    rows = torch.arange(h, device=masks.device, dtype=boxes.dtype)[None, :, None]
    cols = torch.arange(w, device=masks.device, dtype=boxes.dtype)[None, None, :]
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    return masks * ((cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2))


def process_mask(protos: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor,
                 img_shape: Tuple[int, int]) -> torch.Tensor:
    """Each detection's soft mask at the prototypes' resolution, in fp32:
    sigmoid(coeffs @ protos) cropped to its box. protos (nm, h, w), coeffs
    (n, nm), boxes (n, 4) xyxy in network-input pixels of img_shape (H, W).
    The JAX package's ops/boxes.py process_mask (its protos are (h, w, nm))."""
    nm, h, w = protos.shape
    masks = torch.sigmoid(coeffs.float() @ protos.float().reshape(nm, -1)).reshape(-1, h, w)
    scale = torch.tensor([w / img_shape[1], h / img_shape[0], w / img_shape[1], h / img_shape[0]],
                         dtype=torch.float32, device=boxes.device)
    return crop_mask(masks, boxes.float() * scale)


def process_mask_native(protos: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor,
                        img_shape: Tuple[int, int], input_shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Boolean masks at the original image's resolution: the logits at the
    prototypes' resolution without the letterbox pad (JAX's int(round(pad
    -+ 0.1)) crops), resized to img_shape (H, W) as jax.image.resize
    "bilinear" resizes (half-pixel centres, antialiased when it shrinks),
    cropped to the boxes (n, 4, xyxy in original pixels), then logit > 0.
    input_shape is the network input's (H, W), by default 4 x the
    prototypes'. The JAX package's ops/boxes.py process_mask_native."""
    nm, h, w = protos.shape
    if input_shape is None:
        input_shape = (h * 4, w * 4)
    logits = (coeffs.float() @ protos.float().reshape(nm, -1)).reshape(-1, h, w)
    gain = min(input_shape[0] / img_shape[0], input_shape[1] / img_shape[1])
    pad_h = (input_shape[0] - img_shape[0] * gain) / 2 * (h / input_shape[0])
    pad_w = (input_shape[1] - img_shape[1] * gain) / 2 * (w / input_shape[1])
    top, left = int(round(pad_h - 0.1)), int(round(pad_w - 0.1))
    bottom, right = h - int(round(pad_h + 0.1)), w - int(round(pad_w + 0.1))
    logits = logits[:, top:bottom, left:right]
    up = F.interpolate(logits[None], size=tuple(img_shape), mode="bilinear", align_corners=False, antialias=True)[0]
    return crop_mask(up, boxes.float()) > 0.0
