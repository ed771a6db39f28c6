"""Train-time augmentation on the device, inside the train step: mosaic +
affine + HSV + flip, on torch tensors with an explicit torch.Generator.

Counterpart of the JAX package's ops/augment_device.py, with the same
formulas: the cv2 uint8 HSV convention (H in [0, 180)); mosaic as a
batch-level gather of three donors with 114 outside the sources; the affine
(translate and scale; rotation, shear and perspective at their 0 defaults)
sampled as jax.image.scale_and_translate(method="linear", antialias=False)
samples, with its normalised weights and zero weight outside the input;
flip left-right. Labels ride as (B, G, 4) normalised xywh with a validity
mask and come out as (B, 4G, 4); degenerate warped boxes are masked out.
The random draws are the port's own: the same seed gives other numbers than
jax.random.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]
FILL = 114.0


# ---------------------------------------------------------------------------
# HSV (cv2 uint8 convention: H in [0, 180), S/V in [0, 255])
# ---------------------------------------------------------------------------


def rgb_to_hsv_u8(img: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., 3) -> float32 HSV with cv2's uint8 ranges."""
    f = img.float()
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(v == r, (g - b) / safe_c, torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(h * 30.0, 180.0), torch.zeros_like(h))
    s = torch.where(v > 0, 255.0 * c / torch.where(v > 0, v, torch.ones_like(v)), torch.zeros_like(v))
    return torch.stack([h, s, v], -1)


def hsv_to_rgb_u8(hsv: torch.Tensor) -> torch.Tensor:
    """float32 HSV (cv2 uint8 ranges) -> uint8 RGB."""
    h, s, v = hsv[..., 0] / 30.0, hsv[..., 1] / 255.0, hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    rgb = torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)], -1)
    return torch.round(rgb).clamp(0, 255).to(torch.uint8)


def hsv_device(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """The LUT HSV jitter with explicit gains: img (B, H, W, 3) uint8 RGB,
    gains (B, 3) multipliers of H, S and V."""
    hsv = rgb_to_hsv_u8(img)
    g = gains[:, None, None, :].float()
    h = torch.remainder(hsv[..., 0] * g[..., 0], 180.0)
    s = (hsv[..., 1] * g[..., 1]).clamp(0, 255)
    v = (hsv[..., 2] * g[..., 2]).clamp(0, 255)
    return hsv_to_rgb_u8(torch.stack([h, s, v], -1))


# ---------------------------------------------------------------------------
# Mosaic as a batch gather + affine crop
# ---------------------------------------------------------------------------


class AugBatch(NamedTuple):
    img: torch.Tensor  # (B, s, s, 3) uint8
    bboxes: torch.Tensor  # (B, G', 4) normalised xywh
    cls: torch.Tensor  # (B, G')
    mask: torch.Tensor  # (B, G')


def mosaic_offsets(centers: torch.Tensor, s: int) -> torch.Tensor:
    """(B, 2) centres (xc, yc) -> (B, 4, 2) int32 (x, y) offsets of the four
    quadrant images, so that each inner corner meets the centre (cast
    truncates toward zero, as the reference's astype does)."""
    xc, yc = centers[:, 0], centers[:, 1]
    offs = torch.stack([torch.stack([xc - s, yc - s], -1), torch.stack([xc, yc - s], -1),
                        torch.stack([xc - s, yc], -1), torch.stack([xc, yc], -1)], 1)
    return offs.to(torch.int32)


def place(imgs: torch.Tensor, src: torch.Tensor, offs: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The 2s x 2s canvas: pixel (y, x) lies in quadrant q = 2 [y >= yc] + [x >= xc]
    and shows imgs[src[b, q]] at (y - off_y, x - off_x), or 114 outside it.
    imgs (N, s, s, 3) uint8, src (B, 4) indices, offs (B, 4, 2), centers (B, 2)."""
    n, s = imgs.shape[0], imgs.shape[1]
    b, dev = src.shape[0], imgs.device
    r = torch.arange(2 * s, device=dev)
    qy = (r[None, :] >= centers[:, 1:2]).long()  # (B, 2s)
    qx = (r[None, :] >= centers[:, 0:1]).long()
    q = (2 * qy[:, :, None] + qx[:, None, :]).reshape(b, -1)  # (B, 4s^2)
    oy = offs[..., 1].long().gather(1, q).view(b, 2 * s, 2 * s)
    ox = offs[..., 0].long().gather(1, q).view(b, 2 * s, 2 * s)
    sb = src.long().gather(1, q).view(b, 2 * s, 2 * s)
    sy, sx = r[None, :, None] - oy, r[None, None, :] - ox
    inside = (sy >= 0) & (sy < s) & (sx >= 0) & (sx < s)
    flat = (sb * s + sy.clamp(0, s - 1)) * s + sx.clamp(0, s - 1)
    canvas = imgs.reshape(n * s * s, 3)[flat]
    return torch.where(inside[..., None], canvas, torch.full_like(canvas, int(FILL)))


def mosaic_one(srcs, boxes, cls, mask, center) -> Tuple[torch.Tensor, ...]:
    """One mosaic, as the reference mosaic4 places it: srcs (4, s, s, 3) uint8
    (the image and 3 donors), boxes (4, G, 4) pixel xyxy in each source, cls
    and mask (4, G), center (2,) = (xc, yc). Returns the 2s canvas and the
    4G shifted, clipped labels."""
    s = srcs.shape[1]
    offs = mosaic_offsets(center[None], s)
    canvas = place(srcs, torch.arange(4, device=srcs.device)[None], offs, center[None])[0]
    shift = offs[0, :, None, :].float()
    b = (boxes + torch.cat([shift, shift], -1)).clamp(0, 2 * s)
    return canvas, b.reshape(-1, 4), cls.reshape(-1), mask.reshape(-1)


def _axis_weights(n_out: int, n_in: int, k: torch.Tensor, tr: torch.Tensor):
    """The two linear taps of jax.image.scale_and_translate (antialias off)
    along one axis, per image: sample positions (i + 0.5)/k - tr/k - 0.5,
    weights normalised by their sum, zero where the position is outside
    [-0.5, n_in - 0.5]. Returns (i0, i1, w0, w1), each (B, n_out)."""
    inv = 1.0 / k
    sf = (torch.arange(n_out, device=k.device, dtype=torch.float32) + 0.5)[None, :] * inv[:, None] \
        - (tr * inv)[:, None] - 0.5
    i0 = torch.floor(sf)
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < n_in), (1.0 - (sf - i0).abs()).clamp(min=0), torch.zeros_like(sf))
    w1 = torch.where((i1 >= 0) & (i1 < n_in), (1.0 - (sf - i1).abs()).clamp(min=0), torch.zeros_like(sf))
    tot = w0 + w1
    ok = tot.abs() > 1000.0 * torch.finfo(torch.float32).eps
    safe = torch.where(tot != 0, tot, torch.ones_like(tot))
    live = ok & (sf >= -0.5) & (sf <= n_in - 0.5)
    w0 = torch.where(live, w0 / safe, torch.zeros_like(w0))
    w1 = torch.where(live, w1 / safe, torch.zeros_like(w1))
    return i0.long().clamp(0, n_in - 1), i1.long().clamp(0, n_in - 1), w0, w1


def affine_crop(canvas: torch.Tensor, boxes: torch.Tensor, k: torch.Tensor, t: torch.Tensor,
                out_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_out = k (x_canvas - s) + t: canvas (B, 2s, 2s, 3) uint8, boxes (B, N, 4)
    pixel xyxy on the canvas, k (B,) scale, t (B, 2) = (tx, ty). Returns the
    (B, out, out, 3) image (114 where no canvas pixel is sampled), the warped
    boxes and their candidate mask."""
    b, s = canvas.shape[0], canvas.shape[1] // 2
    k = k.float()
    t = t.float()
    # (y, x) translations in scale_and_translate's half-pixel convention
    ty = t[:, 1] - k * s + 0.5 - 0.5 * k
    tx = t[:, 0] - k * s + 0.5 - 0.5 * k
    y0, y1, wy0, wy1 = _axis_weights(out_size, 2 * s, k, ty)
    x0, x1, wx0, wx1 = _axis_weights(out_size, 2 * s, k, tx)
    cv = canvas.float()
    bi = torch.arange(b, device=canvas.device)[:, None, None]

    def row(iy):  # interpolate along x on canvas rows iy: (B, out, out, 3)
        return wx0[:, None, :, None] * cv[bi, iy[:, :, None], x0[:, None, :]] + \
            wx1[:, None, :, None] * cv[bi, iy[:, :, None], x1[:, None, :]]

    img = wy0[:, :, None, None] * row(y0) + wy1[:, :, None, None] * row(y1)
    wx = (wx0 + wx1)[:, None, :]
    ones = wy0[:, :, None] * wx + wy1[:, :, None] * wx
    img = torch.round(img + ((1.0 - ones) * FILL)[..., None]).clamp(0, 255).to(torch.uint8)

    shift = torch.stack([t[:, 0] - k * s, t[:, 1] - k * s], -1)
    nb = boxes * k[:, None, None] + torch.cat([shift, shift], -1)[:, None, :]
    w1 = (boxes[..., 2] - boxes[..., 0]) * k[:, None]
    h1 = (boxes[..., 3] - boxes[..., 1]) * k[:, None]
    nb = nb.clamp(0, out_size)
    w2, h2 = nb[..., 2] - nb[..., 0], nb[..., 3] - nb[..., 1]
    ar = torch.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    cand = (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 + 1e-16) > 0.1) & (ar < 100)
    return img, nb, cand


def mosaic_affine_device(imgs, bboxes_n, cls, mask, donors, centers, scales, trans, use_mosaic) -> AugBatch:
    """Batched mosaic + affine. imgs (B, s, s, 3) uint8, bboxes_n (B, G, 4)
    normalised xywh, donors (B, 3), centers (B, 2) in [s/2, 3s/2], scales
    (B,), trans (B, 2) output pixels, use_mosaic (B,) bool. An image without
    mosaic sits centred on its own 2s canvas and takes the same affine."""
    b, s = imgs.shape[0], imgs.shape[1]
    g = bboxes_n.shape[1]
    dev = imgs.device
    xy = bboxes_n.float() * s
    half = xy[..., 2:4] / 2
    px = torch.cat([xy[..., :2] - half, xy[..., :2] + half], -1)  # (B, G, 4) pixel xyxy

    idx4 = torch.cat([torch.arange(b, device=dev)[:, None], donors.long()], 1)  # (B, 4)
    offs = mosaic_offsets(centers.float(), s)
    um = use_mosaic.bool()
    src = torch.where(um[:, None], idx4, torch.arange(b, device=dev)[:, None].expand(b, 4))
    offs = torch.where(um[:, None, None], offs, torch.full_like(offs, s // 2))
    canvas = place(imgs, src, offs, centers.float())

    shift = offs.float()[:, :, None, :]  # (B, 4, 1, 2)
    mboxes = (px[idx4] + torch.cat([shift, shift], -1)).clamp(0, 2 * s).reshape(b, 4 * g, 4)
    zeros = lambda t: torch.zeros((b, 3 * g) + t.shape[2:], dtype=t.dtype, device=dev)  # noqa: E731
    pboxes = torch.cat([px + s // 2, zeros(px)], 1)
    boxes = torch.where(um[:, None, None], mboxes, pboxes)
    mcls = torch.where(um[:, None], cls[idx4].reshape(b, 4 * g), torch.cat([cls, zeros(cls)], 1))
    mmask = torch.where(um[:, None], mask[idx4].reshape(b, 4 * g), torch.cat([mask, zeros(mask)], 1))

    out_img, out_boxes, cand = affine_crop(canvas, boxes, scales, trans, s)
    out_mask = mmask * cand.to(mmask.dtype)
    wh = out_boxes[..., 2:4] - out_boxes[..., :2]
    ctr = (out_boxes[..., :2] + out_boxes[..., 2:4]) / 2
    out_n = torch.cat([ctr, wh], -1) / s * out_mask[..., None]
    return AugBatch(out_img, out_n, mcls * out_mask, out_mask)


def flip_lr_device(batch: AugBatch, flip: torch.Tensor) -> AugBatch:
    """Horizontal flip of the images where flip[b]."""
    img = torch.where(flip[:, None, None, None], batch.img.flip(2), batch.img)
    bx = batch.bboxes
    fx = torch.where(flip[:, None], (1.0 - bx[..., 0]) * batch.mask, bx[..., 0])
    return AugBatch(img, torch.cat([fx[..., None], bx[..., 1:]], -1), batch.cls, batch.mask)


def device_augment(gen: torch.Generator, img: torch.Tensor, bboxes: torch.Tensor, cls: torch.Tensor,
                   mask: torch.Tensor, hyp: Dict[str, Scalar]) -> AugBatch:
    """The whole on-device train augmentation. All randomness from `gen`
    (on img's device); hyp holds mosaic, scale, translate, fliplr, hsv_h,
    hsv_s, hsv_v as floats or 0-d tensors."""
    b, s = img.shape[0], img.shape[1]
    dev = img.device
    h = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in hyp.items()}

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    donors = torch.randint(0, b, (b, 3), generator=gen, device=dev)
    centers = s / 2 + u(b, 2) * s
    scales = 1.0 - h["scale"] + u(b) * (2 * h["scale"])
    trans = (0.5 - h["translate"]) * s + u(b, 2) * (2 * h["translate"] * s)
    use_mosaic = u(b) < h["mosaic"]
    out = mosaic_affine_device(img, bboxes, cls, mask, donors, centers, scales, trans, use_mosaic)
    gains = (u(b, 3) * 2 - 1) * torch.stack([h["hsv_h"], h["hsv_s"], h["hsv_v"]]) + 1.0
    out = out._replace(img=hsv_device(out.img, gains))
    return flip_lr_device(out, u(b) < h["fliplr"])


def scale_content(x: torch.Tensor, bboxes: torch.Tensor, mask: torch.Tensor, k: torch.Tensor):
    """multi_scale of the JAX train step: the batch's content scaled by k
    about the centre inside the fixed canvas, x (B, C, H, W) float32 resampled
    as jax.image.scale_and_translate(scale k, translation (1 - k) H / 2,
    method="linear", antialias=False) resamples (zero outside the input);
    boxes (B, G, 4) normalised xywh scaled about the centre and clipped to the
    canvas, masked (and zeroed) where the centre leaves it or a side falls to
    1e-3 or under. Returns (x, bboxes, mask)."""
    b, _, h, w = x.shape
    kk = k.reshape(1).float()
    t = (1 - kk) * h / 2
    y0, y1, wy0, wy1 = _axis_weights(h, h, kk, t)
    x0, x1, wx0, wx1 = _axis_weights(w, w, kk, t)
    rows = x[:, :, y0[0]] * wy0[0][:, None] + x[:, :, y1[0]] * wy1[0][:, None]
    out = rows[..., x0[0]] * wx0[0] + rows[..., x1[0]] * wx1[0]
    ctr = (bboxes[..., :2] - 0.5) * k + 0.5
    wh = bboxes[..., 2:4] * k
    lt = (ctr - wh / 2).clamp(0.0, 1.0)
    rb = (ctr + wh / 2).clamp(0.0, 1.0)
    ctr, wh = (lt + rb) / 2, rb - lt
    inside = ((ctr > 0.0) & (ctr < 1.0)).all(-1) & (wh > 1e-3).all(-1)
    mask = mask * inside.to(mask.dtype)
    return out, torch.cat([ctr, wh], -1) * mask[..., None], mask
