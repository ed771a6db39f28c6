"""The loader's sample transforms (counterparts of the JAX package's
data/augment.py): the letterbox, format_sample, the transforms of the
device-augmented and val paths, and the host augmentation stack of
device_augment=False (mosaic 2x2, 3x3 and 1x3, random_perspective, mixup,
pixel_augment, HSV and flips, train_transform), and the instance-aware
stack of the segment and pose tasks (the polygons and keypoints through the
same mosaic, warp, mixup and flips; segment_transform's overlap map or bit
planes of the instances, pose_transform's keypoint targets).

Letterbox: PyTorch's bilinear interpolation with half-pixel centres
(align_corners=False), the rule cv2.INTER_LINEAR follows; cv2 rounds its
uint8 weights to fixed point, so pixels may differ from cv2's by a level or
two. The rect path's shrink (cv2.INTER_AREA in the JAX package) is
`area_resize`: each output pixel the mean of the input area it covers, with
fractional edge weights, as INTER_AREA computes it. The geometry (gain,
padding, ratio_pad, orig_shape) is computed exactly as in the JAX package.
The same code runs on the card (predict) and on CPU tensors in the loader's
worker threads.

The host stack takes the same np.random.Generator as the JAX package's and
draws from it in the same order with the same calls, so the same samples and
seed give the same boxes, classes and generator state. It needs no cv2: the
cv2 operations the JAX package calls are written here in numpy, after the
rules of the cv2 build the JAX package runs with (OpenCV 5): BGR -> HSV in
integer arithmetic (exact), HSV -> BGR in float32 with fused multiply-adds
and truncation (exact on its vector path), warpAffine and warpPerspective
from float32 source coordinates and a float32 bilinear lerp (exact on the
tests' draws), the box blur, the median and BGR -> gray in 15-bit fixed
point (exact), CLAHE (exact), BGR -> LAB in cv2's integer tables (L exact);
only LAB -> BGR after CLAHE is the float formula, within 2 levels of cv2's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.patches import fill_poly


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


def letterbox_geometry(shape: Tuple[int, int], new_shape: Union[int, Tuple[int, int]], scaleup: bool = True):
    """(gain, (new_w, new_h) of the resized content, (left, right, top,
    bottom) pad) of letterboxing an (h, w) frame into new_shape."""
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # (w, h)
    dw, dh = (new_shape[1] - new_unpad[0]) / 2, (new_shape[0] - new_unpad[1]) / 2
    return r, new_unpad, (int(round(dw - 0.1)), int(round(dw + 0.1)), int(round(dh - 0.1)), int(round(dh + 0.1)))


def letterbox(img: Union[np.ndarray, torch.Tensor], new_shape: Union[int, Tuple[int, int]], device=None,
              scaleup: bool = True) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Min-ratio resize and pad (grey 114) of an (H, W, 3) uint8 image, the
    pad split evenly on both sides. scaleup=False only shrinks. Returns
    (image (new_h, new_w, 3) uint8 on `device`, gain, (padw, padh) of the
    top-left pad)."""
    t = torch.as_tensor(img, device=device)
    shape = tuple(t.shape[:2])
    r, new_unpad, (left, right, top, bottom) = letterbox_geometry(shape, new_shape, scaleup)
    if shape[::-1] != new_unpad:
        t = _resize(t, (new_unpad[1], new_unpad[0]))
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


# ---------------------------------------------------------------------------
# The host augmentation stack (device_augment=False): the JAX package's
# data/augment.py random_hsv .. train_transform, with cv2's pixel rules in numpy
# ---------------------------------------------------------------------------

_F32, _F64 = np.float32, np.float64
# BGR -> HSV (uint8): cv2's tables in 12-bit fixed point, hue in [0, 180)
_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int32)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=_F64))
_HDIV = np.zeros(256, np.int32)
_HDIV[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=_F64)))
# HSV -> BGR: for each hue sector, which of (v, p, q, t) each of b, g, r takes
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]], np.intp)
# BGR -> LAB and back (the float formulas, sRGB under D65)
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535], [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]])
_WHITE = np.array([0.950456, 1.0, 1.088754])
BORDER = 114  # the grey of the warps' border and of the mosaic canvas
# rows per band of a warp's lerps: bands keep the float64 temporaries in cache, and few large numpy calls
# let the loader's threads compute without queueing for the GIL (with bands of 16 rows a batch took longer
# over 8 loader threads than over 1 on the H100's host; PERF.md section 6)
WARP_BAND = 128


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as a fused multiply-add computes it."""
    return (np.asarray(a, _F32).astype(_F64) * np.asarray(b, _F32) + np.asarray(c, _F32)).astype(_F32)


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """uint8 BGR -> HSV (H in [0, 180)), cv2's integer rules."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * np.take(_SDIV, v) + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * np.take(_HDIV, diff) + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h += (h < 0) * 180
    return np.stack([h, s, v], -1).astype(np.uint8)


def _hsv_factors() -> np.ndarray:
    """(256 * 256, 3) float32: for each (H, S), the factor of V/255 that each of
    B, G, R takes in cv2's HSV -> BGR (1, 1 - s, 1 - s h or 1 - s (1 - h) by
    the hue's sector), with its fused multiply-adds."""
    h, s = np.meshgrid(np.arange(256, dtype=_F32) * _F32(6.0 / 180), np.arange(256, dtype=_F32) * _F32(1 / 255),
                       indexing="ij")
    sector = np.floor(h)
    h = h - sector
    tab = np.stack([np.ones_like(s), _F32(1) - s, _fma32(-s, h, 1), _fma32(-s, _F32(1) - h, 1)], -1)
    return np.take_along_axis(tab, _SECTORS[sector.astype(np.intp) % 6], -1).reshape(-1, 3)


_HSV_FACTORS = _hsv_factors()


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (H in [0, 180)) -> BGR, cv2's float32 rules: each channel
    (V / 255) times its factor (_HSV_FACTORS), times 255, truncated."""
    f = np.take(_HSV_FACTORS, hsv[..., 0].astype(np.intp) * 256 + hsv[..., 1], axis=0)
    v = hsv[..., 2:3].astype(_F32) * _F32(1 / 255)
    return np.clip(np.trunc(v * f * _F32(255)), 0, 255).astype(np.uint8)


def random_hsv(img: np.ndarray, rng: np.random.Generator, hgain=0.015, sgain=0.7, vgain=0.4) -> np.ndarray:
    """Hue, saturation and value gains through lookup tables (JAX data/augment.py:25)."""
    if hgain or sgain or vgain:
        r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
        x = np.arange(0, 256, dtype=r.dtype)
        lut = np.stack([((x * r[0]) % 180).astype(np.uint8), np.clip(x * r[1], 0, 255).astype(np.uint8),
                        np.clip(x * r[2], 0, 255).astype(np.uint8)])
        hsv = bgr_to_hsv(img)
        img = hsv_to_bgr(np.stack([lut[c][hsv[..., c]] for c in range(3)], -1))
    return img


def rotation_matrix(angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D about the origin: (2, 3), angle in degrees."""
    a = scale * math.cos(math.radians(angle))
    b = scale * math.sin(math.radians(angle))
    return np.array([[a, b, 0.0], [-b, a, 0.0]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform's arithmetic, (2, 3) float64."""
    m = np.asarray(m, _F64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.reshape(2, 3)


def _invert3(m: np.ndarray) -> np.ndarray:
    """cv2.invert of a 3x3 matrix (its closed form by cofactors), float64."""
    s = np.asarray(m, _F64)
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    d = 1.0 / d if d != 0 else 0.0
    return np.array([
        [(s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d, (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
         (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d],
        [(s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d, (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
         (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d],
        [(s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d, (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
         (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d]])


def _warp(img: np.ndarray, coords, dsize: Tuple[int, int], fill: int = BORDER) -> np.ndarray:
    """Sample the (H, W, 3) uint8 image at the float32 source coordinates
    coords(x, y) -> (sx, sy) of each output pixel: a float32 lerp along x,
    then along y, each a fused multiply-add, rounded to nearest; a tap
    outside the image reads `fill` (cv2's BORDER_CONSTANT). The lerps run in
    bands of WARP_BAND rows."""
    h, w = img.shape[:2]
    w_out, h_out = dsize
    pad = np.full((h + 3, w + 3, 4), fill, np.uint8)  # one ring of `fill` before the image, two after
    pad[1:h + 1, 1:w + 1, :3] = img
    px = pad.view(np.uint32).reshape(-1)  # a pixel's 4 bytes in one word, the fourth dropped at the end
    sx, sy = coords(np.arange(w_out, dtype=_F32)[None, :], np.arange(h_out, dtype=_F32)[:, None])
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    # a position whose taps all lie outside reads the ring after the image (index w or h)
    x0 = np.where(x0 < -1, w, np.minimum(x0, w)).astype(np.intp) + 1
    y0 = np.where(y0 < -1, h, np.minimum(y0, h)).astype(np.intp) + 1
    i00 = y0 * (w + 3) + x0
    taps = np.array([0, 1, w + 3, w + 4])[:, None, None]  # (y, x), (y, x + 1), (y + 1, x), (y + 1, x + 1)
    out = np.empty((h_out, w_out, 3), np.uint8)
    for r in range(0, h_out, WARP_BAND):
        band = slice(r, r + WARP_BAND)
        p = np.take(px, i00[band] + taps).view(np.uint8).reshape(4, -1, w_out, 4).astype(_F64)
        # products of a float32 and a small integer, or of two float32s, are exact in float64:
        # one rounding to float32 after the sum is the fused multiply-add
        rows = (fx[band].astype(_F64) * (p[1::2] - p[0::2]) + p[0::2]).astype(_F32)  # the top and bottom lerps
        v = (fy[band].astype(_F64) * (rows[1] - rows[0]) + rows[0]).astype(_F32)
        out[band] = np.clip(np.rint(v), 0, 255).astype(np.uint8)[..., :3]
    return out


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int], fill: int = BORDER) -> np.ndarray:
    """cv2.warpAffine(img, m[:2], dsize=(w, h), borderValue=fill) with INTER_LINEAR."""
    inv = _invert_affine(np.asarray(m)[:2]).astype(_F32)

    def coords(x, y):
        return _fma32(inv[0, 0], x, inv[0, 1] * y + inv[0, 2]), _fma32(inv[1, 0], x, inv[1, 1] * y + inv[1, 2])

    return _warp(img, coords, dsize, fill)


def warp_perspective(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int], fill: int = BORDER) -> np.ndarray:
    """cv2.warpPerspective(img, m, dsize=(w, h), borderValue=fill) with INTER_LINEAR."""
    inv = _invert3(m).astype(_F32)

    def coords(x, y):
        sx, sy, sw = (_fma32(inv[i, 0], x, inv[i, 1] * y + inv[i, 2]) for i in range(3))
        return sx / sw, sy / sw

    return _warp(img, coords, dsize, fill)


def mosaic4(samples: List[Dict], imgsz: int, rng: np.random.Generator) -> Dict:
    """4-image mosaic on a 2*imgsz canvas (JAX data/augment.py:39): samples are
    4 dicts with 'img' (HWC uint8), 'bboxes' pixel xyxy (n, 4) and 'cls' (n,);
    the result carries the border for the affine that follows."""
    s = imgsz
    border = (-s // 2, -s // 2)
    yc = int(rng.uniform(-border[0], 2 * s + border[0]))
    xc = int(rng.uniform(-border[1], 2 * s + border[1]))
    img4 = np.full((s * 2, s * 2, 3), BORDER, dtype=np.uint8)
    cls4, boxes4 = [], []
    for i, sample in enumerate(samples):
        img = sample["img"]
        x1a, y1a, x2a, y2a, x1b, y1b, x2b, y2b = _mosaic4_rects(i, *img.shape[:2], xc, yc, s)
        img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        if len(sample["bboxes"]):
            b = sample["bboxes"].copy()
            b[:, [0, 2]] += x1a - x1b
            b[:, [1, 3]] += y1a - y1b
            boxes4.append(b)
            cls4.append(sample["cls"])
    return _mosaic_out(img4, boxes4, cls4, s, border)


def _mosaic4_rects(i: int, h: int, w: int, xc: int, yc: int, s: int):
    """Where the i-th (h, w) image of a 2x2 mosaic about (xc, yc) goes on the
    2s x 2s canvas (x1a, y1a, x2a, y2a) and which part of it (x1b .. y2b)."""
    if i == 0:  # top left
        x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
        return x1a, y1a, x2a, y2a, w - (x2a - x1a), h - (y2a - y1a), w, h
    if i == 1:  # top right
        x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
        return x1a, y1a, x2a, y2a, 0, h - (y2a - y1a), min(w, x2a - x1a), h
    if i == 2:  # bottom left
        x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
        return x1a, y1a, x2a, y2a, w - (x2a - x1a), 0, w, min(y2a - y1a, h)
    x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)  # bottom right
    return x1a, y1a, x2a, y2a, 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)


def _mosaic_out(img, boxes, cls, s, border) -> Dict:
    bboxes = np.concatenate(boxes, 0) if boxes else np.zeros((0, 4), np.float32)
    c = np.concatenate(cls, 0) if cls else np.zeros((0,), np.float32)
    return {"img": img, "bboxes": np.clip(bboxes, 0, 2 * s), "cls": c, "mosaic_border": border}


def _mosaic_grid(samples: List[Dict], imgsz: int, corners) -> Dict:
    """Patches at the canvas rectangles corners(i, h, w, h0, w0, hp, wp) on a
    3s x 3s canvas, centre-cropped to 2s x 2s (the JAX package's mosaic9 and
    mosaic3)."""
    s = imgsz
    border = (-s // 2, -s // 2)
    canvas = np.full((s * 3, s * 3, 3), BORDER, dtype=np.uint8)
    cls, boxes = [], []
    hp = wp = -1  # the previous patch's h, w
    h0 = w0 = 0
    for i, sample in enumerate(samples):
        img = sample["img"]
        h, w = img.shape[:2]
        if i == 0:
            h0, w0 = h, w
        padw, padh, x2, y2 = corners(i, h, w, h0, w0, hp, wp)
        x1, y1, x2, y2 = max(padw, 0), max(padh, 0), min(max(x2, 0), s * 3), min(max(y2, 0), s * 3)
        if x2 > x1 and y2 > y1:  # a patch wholly off the canvas (an image over 1.5 imgsz wide) pastes nothing
            canvas[y1:y2, x1:x2] = img[y1 - padh: y2 - padh, x1 - padw: x2 - padw]
        hp, wp = h, w
        if len(sample["bboxes"]):
            b = sample["bboxes"].copy()
            b[:, [0, 2]] += padw + border[0]  # relative to the 2s crop
            b[:, [1, 3]] += padh + border[1]
            boxes.append(b)
            cls.append(sample["cls"])
    crop = np.ascontiguousarray(canvas[-border[0]: s * 3 + border[0], -border[1]: s * 3 + border[1]])
    return _mosaic_out(crop, boxes, cls, s, border)


def mosaic9(samples: List[Dict], imgsz: int, rng: np.random.Generator) -> Dict:
    """3x3 mosaic (JAX data/augment.py:85): the centre image and eight donors
    clockwise from the top, each placed by the previous patch's size."""
    s = imgsz

    def corners(i, h, w, h0, w0, hp, wp):  # xmin, ymin, xmax, ymax on the canvas
        return [(s, s, s + w, s + h), (s, s - h, s + w, s), (s + wp, s - h, s + wp + w, s),
                (s + w0, s, s + w0 + w, s + h), (s + w0, s + hp, s + w0 + w, s + hp + h),
                (s + w0 - w, s + h0, s + w0, s + h0 + h), (s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h),
                (s - w, s + h0 - h, s, s + h0), (s - w, s + h0 - hp - h, s, s + h0 - hp)][i]

    return _mosaic_grid(samples[:9], imgsz, corners)


def mosaic3(samples: List[Dict], imgsz: int, rng: np.random.Generator) -> Dict:
    """1x3 mosaic (JAX data/augment.py:145): the centre image, one donor to its
    right, one to its left aligned to its bottom edge."""
    s = imgsz

    def corners(i, h, w, h0, w0, hp, wp):
        return [(s, s, s + w, s + h), (s + w0, s, s + w0 + w, s + h), (s - w, s + h0 - h, s, s + h0)][i]

    return _mosaic_grid(samples[:3], imgsz, corners)


def box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """The warped boxes to keep (JAX data/augment.py:191)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def random_perspective(sample: Dict, rng: np.random.Generator, degrees=0.0, translate=0.1, scale=0.5, shear=0.0,
                       perspective=0.0, border=(0, 0)) -> Dict:
    """Centre, perspective, rotation and scale, shear and translation in one
    warp (JAX data/augment.py:199)."""
    img = sample["img"]
    h = img.shape[0] + border[0] * 2
    w = img.shape[1] + border[1] * 2
    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix(a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h
    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        img = warp_perspective(img, M, (w, h)) if perspective else warp_affine(img, M, (w, h))
    bboxes = sample["bboxes"]
    n = len(bboxes)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)  # corners
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
        new = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        keep = box_candidates(bboxes.T * s, new.T, area_thr=0.10)
        bboxes = new[keep]
        cls = sample["cls"][keep]
    else:
        cls = sample["cls"]
    return {"img": img, "bboxes": bboxes.astype(np.float32), "cls": cls}


def random_flip_lr(sample: Dict, rng: np.random.Generator, p=0.5) -> Dict:
    if rng.random() < p:
        img = np.ascontiguousarray(sample["img"][:, ::-1])
        b = sample["bboxes"].copy()
        b[:, [0, 2]] = img.shape[1] - b[:, [2, 0]]
        return {**sample, "img": img, "bboxes": b}
    return sample


def random_flip_ud(sample: Dict, rng: np.random.Generator, p=0.0) -> Dict:
    if p and rng.random() < p:
        img = np.ascontiguousarray(sample["img"][::-1])
        b = sample["bboxes"].copy()
        b[:, [1, 3]] = img.shape[0] - b[:, [3, 1]]
        return {**sample, "img": img, "bboxes": b}
    return sample


def mixup(a: Dict, b: Dict, rng: np.random.Generator) -> Dict:
    """Beta(32, 32) blend of two images, labels concatenated (JAX data/augment.py:348)."""
    r = rng.beta(32.0, 32.0)
    img = (a["img"].astype(np.float32) * r + b["img"].astype(np.float32) * (1 - r)).astype(np.uint8)
    return {"img": img, "bboxes": np.concatenate([a["bboxes"], b["bboxes"]], 0),
            "cls": np.concatenate([a["cls"], b["cls"]], 0)}


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(img, (k, k)): the k x k mean, border reflected about the edge pixel."""
    h, w = img.shape[:2]
    p = k // 2
    c = np.pad(img, ((p, p), (p, p), (0, 0)), mode="reflect").astype(np.int32).cumsum(0).cumsum(1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    s = c[k:k + h, k:k + w] - c[:h, k:k + w] - c[k:k + h, :w] + c[:h, :w]
    return np.rint(s.astype(_F32) * _F32(1 / (k * k))).astype(np.uint8)


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.medianBlur(img, k): the k x k median, border replicated."""
    h, w = img.shape[:2]
    p = k // 2
    win = np.lib.stride_tricks.sliding_window_view(np.pad(img, ((p, p), (p, p), (0, 0)), mode="edge"), (k, k),
                                                   axis=(0, 1))
    out = np.empty_like(img)
    for y in range(0, h, 64):  # in bands of rows: a window copy of the whole image is k * k times its size
        band = win[y:y + 64].reshape(-1, k * k)
        out[y:y + 64] = np.partition(band, k * k // 2, axis=-1)[:, k * k // 2].reshape(-1, w, 3)
    return out


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """cv2 BGR -> gray in 15-bit fixed point, (H, W) uint8."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def _lab_tables():
    """cv2's 8-bit BGR -> LAB tables: sRGB gamma in 3 fractional bits, the cube
    root (linear below 216/24389) in 15, and the D65 XYZ rows in 12."""
    x = np.arange(256) / 255.0
    gamma = np.rint(255 * 8 * np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)).astype(np.int64)
    t = np.arange(256 * 3 // 2 * 8) / (255.0 * 8)
    cbrt = np.rint((1 << 15) * np.where(t < 0.008856, t * 7.787 + 16 / 116, np.cbrt(t))).astype(np.int64)
    xyz = np.rint((1 << 12) * _RGB2XYZ / _WHITE[:, None]).astype(np.int64)
    return gamma, cbrt, xyz


_LAB_GAMMA, _LAB_CBRT, _LAB_XYZ = _lab_tables()


def bgr_to_lab(img: np.ndarray) -> np.ndarray:
    """uint8 BGR -> LAB as cv2 stores it in uint8 (L * 255 / 100, a + 128,
    b + 128), cv2's integer rules (L exact; a and b off by 1 level on a few
    colours in 100,000)."""

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    b, g, r = (_LAB_GAMMA[img[..., i]] for i in range(3))
    fx, fy, fz = (_LAB_CBRT[descale(r * c[0] + g * c[1] + b * c[2], 12)] for c in _LAB_XYZ)
    lum = descale(((116 * 255 + 50) // 100) * fy - (16 * 255 * (1 << 15) + 50) // 100, 15)
    lab = np.stack([lum, descale(500 * (fx - fy) + (128 << 15), 15), descale(200 * (fy - fz) + (128 << 15), 15)], -1)
    return np.clip(lab, 0, 255).astype(np.uint8)


def lab_to_bgr(lab: np.ndarray) -> np.ndarray:
    """uint8 LAB -> BGR by the float formulas (cv2 uses integer tables: within 2 levels of it)."""
    lum = lab[..., 0] * (100 / 255)
    fy = np.where(lum <= 8, 7.787 * (lum / 903.3) + 16 / 116, (lum + 16) / 116)
    y = np.where(lum <= 8, lum / 903.3, fy ** 3)

    def cube(t):
        return np.where(t > 6 / 29, t ** 3, (t - 16 / 116) / 7.787)

    xyz = np.stack([cube(fy + (lab[..., 1] - 128.0) / 500) * _WHITE[0], y,
                    cube(fy - (lab[..., 2] - 128.0) / 200) * _WHITE[2]], -1)
    rgb = np.clip(xyz @ _XYZ2RGB.T, 0, 1)
    srgb = np.where(rgb <= 0.0031308, 12.92 * rgb, 1.055 * rgb ** (1 / 2.4) - 0.055)
    return np.clip(np.rint(srgb[..., ::-1] * 255), 0, 255).astype(np.uint8)


def clahe(gray: np.ndarray, clip: float, tiles: int = 8) -> np.ndarray:
    """cv2.createCLAHE(clipLimit=clip, tileGridSize=(tiles, tiles)).apply(gray):
    a clipped, redistributed histogram per tile (the image reflected at its
    bottom and right edges to a multiple of the grid), each pixel
    interpolated between its four nearest tiles' lookup tables in float32."""
    h, w = gray.shape
    src = np.pad(gray, ((0, -h % tiles), (0, -w % tiles)), mode="reflect")
    th, tw = src.shape[0] // tiles, src.shape[1] // tiles
    area = th * tw
    limit = max(int(clip * area / 256), 1) if clip > 0 else 0
    luts = np.empty((tiles, tiles, 256), np.uint8)
    for ty in range(tiles):
        for tx in range(tiles):
            hist = np.bincount(src[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw].ravel(), minlength=256)
            if limit > 0:
                clipped = int(np.maximum(hist - limit, 0).sum())
                hist = np.minimum(hist, limit) + clipped // 256
                residual = clipped % 256
                if residual:
                    hist[np.arange(0, 256, max(256 // residual, 1))[:residual]] += 1
            luts[ty, tx] = np.clip(np.rint(np.cumsum(hist).astype(_F32) * _F32(255.0 / area)), 0, 255)

    def axis(n, size):
        f = np.arange(n, dtype=_F32) * (_F32(1) / _F32(size)) - _F32(0.5)
        lo = np.floor(f).astype(np.intp)
        frac = (f - lo).astype(_F32)
        return np.maximum(lo, 0), np.minimum(lo + 1, tiles - 1), frac

    x1, x2, xa = axis(w, tw)
    y1, y2, ya = axis(h, th)
    y1, y2, ya = y1[:, None], y2[:, None], ya[:, None]
    top = luts[y1, x1, gray] * (_F32(1) - xa) + luts[y1, x2, gray] * xa
    bottom = luts[y2, x1, gray] * (_F32(1) - xa) + luts[y2, x2, gray] * xa
    return np.clip(np.rint(top * (_F32(1) - ya) + bottom * ya), 0, 255).astype(np.uint8)


def pixel_augment(img: np.ndarray, rng: np.random.Generator, p: float = 1.0) -> np.ndarray:
    """Blur, median blur, gray and CLAHE on the L of LAB, each with
    probability 0.01 (JAX data/augment.py:360: the reference's Albumentations
    defaults)."""
    if rng.random() >= p:
        return img
    if rng.random() < 0.01:  # Blur
        img = box_blur(img, int(rng.integers(1, 4)) * 2 + 1)
    if rng.random() < 0.01:  # MedianBlur
        img = median_blur(img, int(rng.integers(1, 4)) * 2 + 1)
    if rng.random() < 0.01:  # ToGray
        img = np.repeat(bgr_to_gray(img)[..., None], 3, axis=-1)
    if rng.random() < 0.01:  # CLAHE
        clip = float(rng.uniform(1.0, 4.0))
        lab = bgr_to_lab(img)
        lab[..., 0] = clahe(lab[..., 0], clip)
        img = lab_to_bgr(lab)
    return img


def train_transform(samples: List[Dict], imgsz: int, max_gt: int, rng: np.random.Generator,
                    hyp: Dict) -> Dict[str, np.ndarray]:
    """The host train pipeline for one output image (JAX data/augment.py:388):
    mosaic (2x2, or 3x3 / 1x3 with probability mosaic9 / mosaic3), or the
    letterbox; random_perspective; mixup with a second 2x2 mosaic;
    pixel_augment; HSV; flips. samples: the main sample, then its donors
    (3, or 8 with mosaic9, plus 4 with mixup)."""
    use_mosaic = rng.random() < hyp.get("mosaic", 1.0)
    use_9 = use_mosaic and len(samples) >= 9 and rng.random() < hyp.get("mosaic9", 0.0)
    use_3 = use_mosaic and not use_9 and len(samples) >= 3 and rng.random() < hyp.get("mosaic3", 0.0)
    warp = {k: hyp.get(k, d) for k, d in (("degrees", 0.0), ("translate", 0.1), ("scale", 0.5), ("shear", 0.0),
                                          ("perspective", 0.0))}
    if use_mosaic:
        m = (mosaic9(samples[:9], imgsz, rng) if use_9 else mosaic3(samples[:3], imgsz, rng) if use_3
             else mosaic4(samples[:4], imgsz, rng))
        border = m.pop("mosaic_border")
    else:
        s0 = samples[0]
        img, r, (padw, padh) = letterbox(s0["img"], imgsz)
        m = {"img": img.numpy(), "bboxes": _shift_boxes(s0["bboxes"], r, padw, padh), "cls": s0["cls"]}
        border = (0, 0)
    m = random_perspective(m, rng, border=border, **warp)
    mix_lo = 9 if use_9 else 4  # the mixup donors follow the mosaic's
    if use_mosaic and len(samples) >= mix_lo + 4 and rng.random() < hyp.get("mixup", 0.0):
        m2 = mosaic4(samples[mix_lo: mix_lo + 4], imgsz, rng)
        m2 = random_perspective(m2, rng, border=m2.pop("mosaic_border"), **warp)
        m = mixup(m, m2, rng)
    m["img"] = pixel_augment(m["img"], rng, hyp.get("pixel_augment", 1.0))
    m["img"] = random_hsv(m["img"], rng, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4))
    m = random_flip_ud(m, rng, hyp.get("flipud", 0.0))
    m = random_flip_lr(m, rng, hyp.get("fliplr", 0.5))
    return format_sample(m, imgsz, max_gt)


# ---------------------------------------------------------------------------
# The instance-aware host stack of the segment and pose tasks (JAX data/augment.py:465-545,
# :611-909): the polygons and keypoints ride the same mosaic, warp, mixup and flips as the boxes;
# the segment targets add an overlap map (or bit planes) of the instances at imgsz / mask_ratio,
# filled with cv2.fillPoly's rule (utils/patches.py fill_poly), the pose targets the keypoints.
# An instance has a polygon in pixels, or None for a box-only label, and keypoints (nk, 3) in
# pixels with their visibility, or None.


def _inst_px(sample: Dict) -> Dict:
    """A loader sample with its polygons and keypoints in pixels, beside its xyxy pixel boxes."""
    h, w = sample["img"].shape[:2]
    n = len(sample["cls"])
    polys = list(sample.get("segments") or [None] * n)
    polys = [None if j >= len(polys) or polys[j] is None else polys[j] * np.array([w, h], np.float32)
             for j in range(n)]
    kpts = list(sample.get("kpts") or [None] * n)
    px_kpts = []
    for j in range(n):
        k = kpts[j] if j < len(kpts) else None
        if k is not None:
            k = k.copy()
            k[:, 0] *= w
            k[:, 1] *= h
        px_kpts.append(k)
    return {"img": sample["img"], "bboxes": sample["bboxes"].astype(np.float32), "cls": sample["cls"], "polys": polys,
            "kpts": px_kpts}


def _map_kpts(s: Dict, fn) -> List:
    """fn applied to each instance's keypoints (None stays None); [] for a sample without them."""
    return [None if k is None else fn(k) for k in s.get("kpts", [])]


def _shift_inst(s: Dict, dx: float, dy: float) -> Dict:
    b = s["bboxes"].copy()
    if len(b):
        b[:, [0, 2]] += dx
        b[:, [1, 3]] += dy
    return {**s, "bboxes": b,
            "polys": [None if p is None else p + np.array([dx, dy], np.float32) for p in s["polys"]],
            "kpts": _map_kpts(s, lambda k: np.concatenate([k[:, :2] + np.array([dx, dy], np.float32), k[:, 2:]], 1))}


def _scale_inst(s: Dict, r: float, padw: int, padh: int) -> Dict:
    """Boxes, polygons and keypoints scaled by the letterbox gain r, then shifted by its pad."""
    return _shift_inst({**s, "bboxes": s["bboxes"] * r, "polys": [None if p is None else p * r for p in s["polys"]],
                        "kpts": _map_kpts(s, lambda k: np.concatenate([k[:, :2] * r, k[:, 2:]], 1))}, padw, padh)


def mosaic4_inst(samples: List[Dict], imgsz: int, rng: np.random.Generator) -> Dict:
    """mosaic4 of instance samples: the same draws and canvas, the polygons and keypoints shifted with their boxes."""
    s = imgsz
    border = (-s // 2, -s // 2)
    yc = int(rng.uniform(-border[0], 2 * s + border[0]))
    xc = int(rng.uniform(-border[1], 2 * s + border[1]))
    img4 = np.full((s * 2, s * 2, 3), BORDER, dtype=np.uint8)
    parts = []
    for i, sample in enumerate(samples):
        x1a, y1a, x2a, y2a, x1b, y1b, x2b, y2b = _mosaic4_rects(i, *sample["img"].shape[:2], xc, yc, s)
        img4[y1a:y2a, x1a:x2a] = sample["img"][y1b:y2b, x1b:x2b]
        parts.append(_shift_inst(sample, x1a - x1b, y1a - y1b))
    return {"img": img4, "bboxes": np.clip(np.concatenate([p["bboxes"] for p in parts], 0), 0, 2 * s),
            "cls": np.concatenate([p["cls"] for p in parts], 0), "polys": sum((p["polys"] for p in parts), []),
            "kpts": sum((p["kpts"] for p in parts), []), "mosaic_border": border}


def random_perspective_inst(sample: Dict, rng: np.random.Generator, degrees=0.0, translate=0.1, scale=0.5,
                            shear=0.0, perspective=0.0, border=(0, 0)) -> Dict:
    """random_perspective of an instance sample: its draws and warp; each
    polygon goes through the matrix and its box becomes the clipped
    polygon's extent (a box-only instance: its warped corners' extent), each
    instance's keypoints go through the matrix too and a point that leaves
    the frame gets visibility 0, and box_candidates keeps instances with an
    area threshold of 0.01 where the sample has a polygon, else 0.10."""
    img = sample["img"]
    h = img.shape[0] + border[0] * 2
    w = img.shape[1] + border[1] * 2
    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    sc = rng.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix(a, sc)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h
    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        img = warp_perspective(img, M, (w, h)) if perspective else warp_affine(img, M, (w, h))

    def warp_pts(pts):  # (K, 2) -> (K, 2)
        xy = np.ones((len(pts), 3))
        xy[:, :2] = pts
        xy = xy @ M.T
        return (xy[:, :2] / xy[:, 2:3]) if perspective else xy[:, :2]

    n = len(sample["cls"])
    new_boxes = np.zeros((n, 4), np.float32)
    new_polys = []
    kpts = sample.get("kpts") or [None] * n
    new_kpts = []
    for j in range(n):
        poly = sample["polys"][j]
        if poly is not None:
            pts = warp_pts(poly).astype(np.float32)
            new_polys.append(pts)
        else:
            b = sample["bboxes"][j]
            pts = warp_pts(np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]]))
            new_polys.append(None)
        cp = np.clip(pts, [0, 0], [w, h])
        new_boxes[j] = [cp[:, 0].min(), cp[:, 1].min(), cp[:, 0].max(), cp[:, 1].max()]
        q = None
        if kpts[j] is not None:
            q = kpts[j].copy()
            q[:, :2] = warp_pts(q[:, :2]).astype(np.float32)
            q[(q[:, 0] < 0) | (q[:, 0] > w) | (q[:, 1] < 0) | (q[:, 1] > h), 2] = 0  # left the frame: invisible
        new_kpts.append(q)
    keep = box_candidates(sample["bboxes"].T * sc, new_boxes.T,
                          area_thr=0.01 if any(p is not None for p in sample["polys"]) else 0.10)
    return {"img": img, "bboxes": new_boxes[keep], "cls": sample["cls"][keep],
            "polys": [p for p, k in zip(new_polys, keep) if k], "kpts": [q for q, k in zip(new_kpts, keep) if k]}


def flip_inst(s: Dict, rng: np.random.Generator, flipud=0.0, fliplr=0.5, flip_idx=None) -> Dict:
    """Up-down (probability flipud) then left-right (fliplr) flips of an
    instance sample; a generator draw only for a flip whose probability is
    not 0. A left-right flip mirrors the keypoints and, with flip_idx,
    reorders them (left and right points swap names), as the JAX package's
    flip_inst does when it is handed flip_idx."""
    h, w = s["img"].shape[:2]
    out = dict(s)
    if flipud and rng.random() < flipud:
        b = out["bboxes"].copy()
        b[:, [1, 3]] = h - b[:, [3, 1]]
        out.update(img=np.ascontiguousarray(out["img"][::-1]), bboxes=b,
                   polys=[None if p is None else np.stack([p[:, 0], h - p[:, 1]], 1) for p in out["polys"]],
                   kpts=_map_kpts(out, lambda k: np.concatenate([k[:, :1], h - k[:, 1:2], k[:, 2:]], 1)))
    if fliplr and rng.random() < fliplr:
        b = out["bboxes"].copy()
        b[:, [0, 2]] = w - b[:, [2, 0]]

        def flip_k(k):
            q = np.concatenate([w - k[:, :1], k[:, 1:]], 1)
            return q[np.asarray(flip_idx)] if flip_idx is not None else q

        out.update(img=np.ascontiguousarray(out["img"][:, ::-1]), bboxes=b,
                   polys=[None if p is None else np.stack([w - p[:, 0], p[:, 1]], 1) for p in out["polys"]],
                   kpts=_map_kpts(out, flip_k))
    return out


def copy_paste_inst(s: Dict, rng: np.random.Generator, p: float = 0.5, donor: Optional[Dict] = None) -> Dict:
    """Copy-paste of instances (JAX data/augment.py:546): the candidates are
    `donor`'s instances (mixup mode), or this sample's own mirrored left to
    right (flip mode, donor None). Those with a polygon whose box covers
    under 30 % (IoA) of every existing box, ordered by their largest IoA
    (np.argsort's order, as JAX's), the first round(p * n) of them, are
    filled (utils/patches.py fill_poly, cv2.fillPoly's rule) into one paste
    mask under which the candidates' pixels replace this sample's, and are
    appended to its instances (without keypoints, as in the JAX package).
    No generator draw; `rng` is JAX's signature."""
    n = len(s["cls"])
    if p <= 0 or n == 0:
        return s
    h, w = s["img"].shape[:2]
    if donor is None:
        if all(q is None for q in s["polys"]):
            return s
        src_img = np.ascontiguousarray(s["img"][:, ::-1])
        cand_boxes = s["bboxes"].copy()
        cand_boxes[:, [0, 2]] = w - s["bboxes"][:, [2, 0]]
        cand_cls = s["cls"]
        cand_polys = [None if q is None else np.stack([w - q[:, 0], q[:, 1]], 1) for q in s["polys"]]
    else:
        if len(donor["cls"]) == 0 or all(q is None for q in donor["polys"]):
            return s
        src_img, cand_boxes, cand_cls, cand_polys = donor["img"], donor["bboxes"], donor["cls"], donor["polys"]
    lt = np.maximum(cand_boxes[:, None, :2], s["bboxes"][None, :, :2])
    rb = np.minimum(cand_boxes[:, None, 2:], s["bboxes"][None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)  # (candidates, existing)
    area = np.maximum((cand_boxes[:, 2] - cand_boxes[:, 0]) * (cand_boxes[:, 3] - cand_boxes[:, 1]), 1e-9)
    ioa = inter / area[:, None]
    ok = np.nonzero(((ioa < 0.30).all(1)) & np.array([q is not None for q in cand_polys]))[0]
    if len(ok) == 0:
        return s
    ok = ok[np.argsort(ioa[ok].max(1))][: round(p * len(ok))]
    if len(ok) == 0 or src_img.shape[:2] != (h, w):
        return s
    paste = np.zeros((h, w), np.uint8)
    for j in ok:
        fill_poly(paste, np.round(cand_polys[j]).astype(np.int32), 1)
    img = s["img"].copy()
    sel = paste == 1
    img[sel] = src_img[sel]
    out = {**s, "img": img, "bboxes": np.concatenate([s["bboxes"], cand_boxes[ok]], 0),
           "cls": np.concatenate([s["cls"], np.asarray([cand_cls[j] for j in ok], s["cls"].dtype)], 0),
           "polys": s["polys"] + [cand_polys[j] for j in ok]}
    if "kpts" in s:
        out["kpts"] = s["kpts"] + [None] * len(ok)
    return out


def geometric_train_transform(samples: List[Dict], imgsz: int, rng: np.random.Generator, hyp: Dict,
                              flip_idx=None) -> Dict:
    """The instance tasks' train pipeline for one output image (JAX
    data/augment.py:727): a 2x2 mosaic (or the letterbox), copy_paste in
    flip mode, random_perspective, copy_paste in mixup mode (with copy_paste
    above 0 and 8 samples or more: a donor mosaic of the last four samples
    after its own random_perspective), mixup with a second mosaic of samples
    4 to 7, pixel_augment, HSV, flips (flip_idx: flip_inst's). The
    generator's draws are JAX's, among them mixup's rng.random() wherever 8
    samples or more come (in mixup mode with mixup 0 too). Returns a
    pixel-space instance sample."""
    insts = [_inst_px(s) for s in samples]
    warp = {k: hyp.get(k, d) for k, d in (("degrees", 0.0), ("translate", 0.1), ("scale", 0.5), ("shear", 0.0),
                                          ("perspective", 0.0))}
    copy_paste = hyp.get("copy_paste", 0.0)
    cp_mode = str(hyp.get("copy_paste_mode", "flip") or "flip")
    use_mosaic = rng.random() < hyp.get("mosaic", 1.0)
    if use_mosaic and len(insts) >= 4:
        m = mosaic4_inst(insts[:4], imgsz, rng)
        border = m.pop("mosaic_border")
    else:
        img, r, (padw, padh) = letterbox(insts[0]["img"], imgsz)
        m = {**_scale_inst(insts[0], r, padw, padh), "img": img.numpy()}
        border = (0, 0)
    if cp_mode == "flip":
        m = copy_paste_inst(m, rng, copy_paste)
    m = random_perspective_inst(m, rng, border=border, **warp)
    if cp_mode == "mixup" and copy_paste > 0 and len(insts) >= 8:
        d = mosaic4_inst(insts[-4:], imgsz, rng)
        d = random_perspective_inst(d, rng, border=d.pop("mosaic_border"), **warp)
        m = copy_paste_inst(m, rng, copy_paste, donor=d)
    if use_mosaic and len(insts) >= 8 and rng.random() < hyp.get("mixup", 0.0):
        m2 = mosaic4_inst(insts[4:8], imgsz, rng)
        m2 = random_perspective_inst(m2, rng, border=m2.pop("mosaic_border"), **warp)
        r = rng.beta(32.0, 32.0)
        m = {"img": (m["img"].astype(np.float32) * r + m2["img"].astype(np.float32) * (1 - r)).astype(np.uint8),
             "bboxes": np.concatenate([m["bboxes"], m2["bboxes"]], 0), "cls": np.concatenate([m["cls"], m2["cls"]], 0),
             "polys": m["polys"] + m2["polys"], "kpts": m["kpts"] + m2["kpts"]}
    m["img"] = pixel_augment(m["img"], rng, hyp.get("pixel_augment", 1.0))
    m["img"] = random_hsv(m["img"], rng, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4))
    return flip_inst(m, rng, hyp.get("flipud", 0.0), hyp.get("fliplr", 0.5), flip_idx)


def _val_inst(sample: Dict, imgsz: int) -> Dict:
    """The val letterbox (never up) of an instance sample, with ratio_pad."""
    img, r, (padw, padh) = letterbox(sample["img"], imgsz, scaleup=False)
    m = {**_scale_inst(_inst_px(sample), r, padw, padh), "img": img.numpy()}
    m["ratio_pad"] = np.array([r, padw, padh], np.float32)
    return m


def _fill_instance(target: np.ndarray, poly, box, ratio: int, value: int) -> None:
    """Fill one instance into target at 1 / ratio of the image: its polygon
    (vertices rounded, cv2.fillPoly's rule), or a box-only label's box."""
    if poly is None:
        x1, y1, x2, y2 = (box / ratio).astype(int)
        target[max(y1, 0):y2, max(x1, 0):x2] = value
    else:
        fill_poly(target, np.round(poly / ratio).astype(np.int32), value)


def segment_transform(sample, imgsz: int, max_gt: int, train: bool, rng, hyp: Dict) -> Dict[str, np.ndarray]:
    """The segment task's sample (JAX data/augment.py:816): train runs
    geometric_train_transform on the main sample and its donors, val the
    letterbox. Beside format_sample's keys and ratio_pad, `seg_map`: the
    overlap map (imgsz / ratio)^2 int32, each pixel the index + 1 of the
    smallest instance over it (the instances filled largest box first), at
    ratio = mask_ratio in train and 4 in val; or, in train with
    overlap_mask false, (ceil(max_gt / 32), s, s) int32 bit planes,
    instance j in plane j // 32, bit j % 32, each instance whole."""
    if train:
        m = geometric_train_transform(sample if isinstance(sample, list) else [sample], imgsz, rng, hyp)
        rp = np.array([1.0, 0.0, 0.0], np.float32)
    else:
        m = _val_inst(sample[0] if isinstance(sample, list) else sample, imgsz)
        rp = m["ratio_pad"]
    out = format_sample({k: m[k] for k in ("img", "bboxes", "cls")}, imgsz, max_gt)
    ratio = int(hyp.get("mask_ratio", 4) or 4) if train else 4
    ms = imgsz // ratio
    n = min(len(m["bboxes"]), max_gt)
    polys = [m["polys"][j] if j < len(m["polys"]) else None for j in range(n)]
    if train and not bool(hyp.get("overlap_mask", True)):
        seg = np.zeros(((max_gt + 31) // 32, ms, ms), np.int32)
        for j in range(n):
            one = np.zeros((ms, ms), np.uint8)
            _fill_instance(one, polys[j], m["bboxes"][j], ratio, 1)
            seg[j // 32] |= one.astype(np.int32) << (j % 32)
    else:
        seg = np.zeros((ms, ms), np.int32)
        order = np.argsort([-(bb[2] - bb[0]) * (bb[3] - bb[1]) for bb in m["bboxes"][:n]]) if n else []
        for j in order:  # largest first: a smaller instance overwrites
            _fill_instance(seg, polys[j], m["bboxes"][j], ratio, int(j + 1))
    out["seg_map"] = seg
    out["ratio_pad"] = rp
    return out


def pose_transform(sample, imgsz: int, max_gt: int, kpt_shape, train: bool, rng, hyp: Dict,
                   flip_idx=None) -> Dict[str, np.ndarray]:
    """The pose task's sample (JAX data/augment.py:886): train runs
    geometric_train_transform on the main sample and its donors (flip_idx
    reorders the keypoints of a left-right flip), val the letterbox. Beside
    format_sample's keys, `kpts`: (max_gt, nk, 3) float32, each instance's
    keypoints with x and y normalised by imgsz and the visibility, a point
    of visibility 0 at (0, 0), zeros for an instance without keypoints. The
    JAX package's val sample has no ratio_pad, nor has this one."""
    if train:
        m = geometric_train_transform(sample if isinstance(sample, list) else [sample], imgsz, rng, hyp, flip_idx)
    else:
        m = _val_inst(sample[0] if isinstance(sample, list) else sample, imgsz)
    out = format_sample({k: m[k] for k in ("img", "bboxes", "cls")}, imgsz, max_gt)
    nk = kpt_shape[0]
    kp = np.zeros((max_gt, nk, 3), np.float32)
    for j in range(min(len(m["cls"]), max_gt)):
        k = m["kpts"][j] if j < len(m["kpts"]) else None
        if k is not None:
            q = k.astype(np.float32)  # a copy
            q[:, 0] /= imgsz
            q[:, 1] /= imgsz
            q[q[:, 2] == 0, :2] = 0  # an invisible point keeps no coordinates
            kp[j, :len(q)] = q[:nk]
    out["kpts"] = kp
    return out
