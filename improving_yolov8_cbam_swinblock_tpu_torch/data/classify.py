"""Image-folder classification data (counterpart of the JAX package's data/classify.py and its classify
transforms, data/transforms.py:378-465).

`ClassificationDataset` reads `root/<class>/*.<image>` (classes sorted by
name, images sorted within each); `ClassificationLoader` yields batches
{"img": (B, s, s, 3) uint8 RGB, "label": (B,) int32}. Train: a random crop
of 0.5 to 1 of each side, a left-right flip at 0.5, the resize to s x s,
RandAugment (`randaugment`: two of its 11 operations at magnitude 9) and
random erasing of a rectangle at `erasing`; val: the resize only. Each
sample draws from its own numpy Generator, seeded by the slot as the JAX
loader seeds it, and makes the same calls in the same order, so the same
seed gives the same crops, flips, operations and rectangles. The last val
batch wraps around to the first images, as the JAX loader's does.

Pixels go through the port's numpy host stack, not cv2: the resize is
PyTorch's bilinear rule (data/augment.py `_resize`; cv2.INTER_LINEAR's
rule, but cv2 rounds its weights to fixed point: within 1 level of it),
the affine operations `warp_affine` (cv2.warpAffine's float32
source coordinates and lerps), and the 3x3 Gaussian blur, BGR <-> YCrCb and
the histogram equalisation cv2's integer rules, bit for bit.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.patches import imread
from .augment import _resize, warp_affine
from .dataset import IMG_EXTS

RANDAUGMENT_FILL = 128  # the grey of the affine operations' border


def resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 (H, W, 3) resized to (h, w): bilinear, half-pixel centres."""
    return _resize(torch.from_numpy(np.ascontiguousarray(img)), (h, w)).numpy()


def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), 0) of uint8: the [1, 2, 1] / 4 kernel
    on both axes, reflect-101 border, cv2's fixed-point sum rounded half up."""
    p = np.pad(img.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="reflect")
    h = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]
    return ((h[:-2] + 2 * h[1:-1] + h[2:] + 8) >> 4).astype(np.uint8)


def bgr_to_ycrcb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2YCrCb) of uint8, its 14-bit integer rules."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    y = (b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14
    cr = ((r - y) * 11682 + (128 << 14) + (1 << 13)) >> 14
    cb = ((b - y) * 9241 + (128 << 14) + (1 << 13)) >> 14
    return np.clip(np.stack([y, cr, cb], -1), 0, 255).astype(np.uint8)


def ycrcb_to_bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_YCrCb2BGR) of uint8, its 14-bit integer rules."""
    y, cr, cb = (img[..., i].astype(np.int32) for i in range(3))
    cr, cb = cr - 128, cb - 128
    b = y + ((cb * 29049 + (1 << 13)) >> 14)
    g = y + ((cb * -5636 + cr * -11698 + (1 << 13)) >> 14)
    r = y + ((cr * 22987 + (1 << 13)) >> 14)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def equalize_hist(ch: np.ndarray) -> np.ndarray:
    """cv2.equalizeHist of one uint8 channel: the lookup of the cumulative
    histogram past the first occupied level, times 255 / (total - its count)
    in float32, rounded to nearest even."""
    hist = np.bincount(ch.reshape(-1), minlength=256)
    i = int(np.flatnonzero(hist)[0])
    if hist[i] == ch.size:
        return np.full_like(ch, i)
    scale = np.float32(255.0) / np.float32(ch.size - hist[i])
    lut = np.zeros(256, np.uint8)
    lut[i + 1:] = np.clip(np.rint(np.cumsum(hist[i + 1:]).astype(np.float32) * scale), 0, 255).astype(np.uint8)
    return lut[ch]


def rotation_matrix2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, angle in degrees, counter-clockwise."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def randaugment(img: np.ndarray, rng: np.random.Generator, n: int = 2, m: int = 9) -> np.ndarray:
    """The JAX package's RandAugment (torchvision's defaults N=2, M=9 of 31):
    n operations drawn first (rng.integers(0, 11, n)), then each applied in
    turn, drawing its sign as it runs. uint8 BGR in and out."""
    h, w = img.shape[:2]
    mag = m / 30.0

    def affine(mat):
        return warp_affine(img, np.asarray(mat, np.float64), (w, h), fill=RANDAUGMENT_FILL)

    def sign():
        return rng.choice([-1, 1])

    def scaled(f):
        return np.clip(img.astype(np.float32) * f, 0, 255).astype(np.uint8)

    def op_rotate():
        return affine(rotation_matrix2d((w / 2, h / 2), sign() * mag * 30.0, 1.0))

    def op_shear_x():
        s = sign() * mag * 0.3
        return affine(np.float32([[1, s, -s * h / 2], [0, 1, 0]]))

    def op_shear_y():
        s = sign() * mag * 0.3
        return affine(np.float32([[1, 0, 0], [s, 1, -s * w / 2]]))

    def op_translate_x():
        return affine(np.float32([[1, 0, sign() * mag * 0.45 * w], [0, 1, 0]]))

    def op_translate_y():
        return affine(np.float32([[1, 0, 0], [0, 1, sign() * mag * 0.45 * h]]))

    def op_brightness():
        return scaled(1.0 + sign() * mag * 0.9)

    def op_contrast():
        f = 1.0 + sign() * mag * 0.9
        x = img.astype(np.float32)
        mean = x.mean()
        return np.clip((x - mean) * f + mean, 0, 255).astype(np.uint8)

    def op_sharpness():
        blur = gaussian_blur3(img).astype(np.float32)
        f = 1.0 + sign() * mag * 0.9
        return np.clip(blur + (img.astype(np.float32) - blur) * f, 0, 255).astype(np.uint8)

    def op_posterize():
        bits = max(1, 8 - int(round(mag * 4)))
        return img & np.uint8((0xFF << (8 - bits)) & 0xFF)

    def op_solarize():
        thr = int(255 - mag * 255)
        return np.where(img >= thr, 255 - img, img).astype(np.uint8)

    def op_equalize():
        ycrcb = bgr_to_ycrcb(img)
        ycrcb[..., 0] = equalize_hist(ycrcb[..., 0])
        return ycrcb_to_bgr(ycrcb)

    ops = [op_rotate, op_shear_x, op_shear_y, op_translate_x, op_translate_y,
           op_brightness, op_contrast, op_sharpness, op_posterize, op_solarize, op_equalize]
    for idx in rng.integers(0, len(ops), n):
        img = ops[int(idx)]()
    return img


class ClassificationDataset:
    """The images of `root/<class>/`: `samples` [(path, class index)], `nc`,
    `names` {index: class}. auto_augment is "randaugment" or None (the JAX
    package's others raise ValueError)."""

    def __init__(self, root, imgsz: int = 224, erasing: float = 0.0, auto_augment: Optional[str] = None):
        self.root = Path(root)
        self.imgsz = int(imgsz)
        self.erasing = float(erasing)
        if auto_augment not in (None, "", "randaugment"):
            raise ValueError(f"auto_augment={auto_augment!r} not supported (only 'randaugment'; the reference "
                             "dispatches autoaugment and augmix to torchvision)")
        self.auto_augment = auto_augment or None
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [(str(p), self.class_to_idx[c]) for c in classes
                        for p in sorted((self.root / c).rglob("*")) if p.suffix.lower() in IMG_EXTS]
        if not self.samples:
            raise FileNotFoundError(f"no class images under {root}")
        self.nc = len(classes)
        self.names = {i: c for c, i in self.class_to_idx.items()}

    def __len__(self):
        return len(self.samples)

    def load(self, idx: int, train: bool, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Sample idx: {"img": (s, s, 3) uint8 RGB, "label": int32}, drawing from rng as the JAX package's does."""
        path, label = self.samples[idx]
        img = imread(path)
        if img is None:
            raise FileNotFoundError(f"cannot read {path}")
        if train:  # a random crop of 0.5 to 1 of each side, then a left-right flip at 0.5
            h, w = img.shape[:2]
            s = rng.uniform(0.5, 1.0)
            ch, cw = int(h * s), int(w * s)
            y0 = int(rng.integers(0, h - ch + 1))
            x0 = int(rng.integers(0, w - cw + 1))
            img = img[y0:y0 + ch, x0:x0 + cw]
            if rng.random() < 0.5:
                img = img[:, ::-1]
        img = resize(img, self.imgsz, self.imgsz)
        if train and self.auto_augment == "randaugment":
            img = randaugment(img, rng)
        img = np.ascontiguousarray(img[..., ::-1])
        if train and self.erasing > 0 and rng.random() < self.erasing:
            # zero a rectangle of 2 to 33 % of the image, of aspect 0.3 to 3.3: ten tries
            for _ in range(10):
                area = self.imgsz * self.imgsz * rng.uniform(0.02, 0.33)
                ar = float(np.exp(rng.uniform(np.log(0.3), np.log(3.3))))
                eh, ew = int(round(np.sqrt(area * ar))), int(round(np.sqrt(area / ar)))
                if eh < self.imgsz and ew < self.imgsz:
                    y0 = int(rng.integers(0, self.imgsz - eh + 1))
                    x0 = int(rng.integers(0, self.imgsz - ew + 1))
                    img[y0:y0 + eh, x0:x0 + ew] = 0
                    break
        return {"img": img, "label": np.int32(label)}


class ClassificationLoader:
    """Batches of a ClassificationDataset on worker threads. Train: len(ds)
    // batch batches a epoch in the order of a permutation seeded by seed +
    epoch; val: ceil(len(ds) / batch) in file order, the last batch filled
    by wrapping around to the first images (slot j of batch b is (b * batch
    + j) % len(ds)), as the JAX loader fills it. Slot s draws from
    np.random.default_rng((seed + epoch) * 1_000_003 + s)."""

    def __init__(self, dataset: ClassificationDataset, batch_size: int, train: bool = True, seed: int = 0,
                 workers: int = 8):
        self.ds = dataset
        self.bs = int(batch_size)
        self.train = train
        self.seed = int(seed)
        self.epoch = 0
        self.workers = max(1, int(workers))
        n = len(dataset)
        self.batches_per_epoch = max(1, n // self.bs) if train else int(np.ceil(n / self.bs))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def close_mosaic(self):
        pass

    def __len__(self):
        return self.batches_per_epoch

    def __iter__(self):
        n = len(self.ds)
        base = self.seed + self.epoch
        idx = np.random.default_rng(base).permutation(n) if self.train else np.arange(n)
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            def submit(b):
                slots = [(b * self.bs + j) % n for j in range(self.bs)]
                return [pool.submit(self.ds.load, int(idx[s]), self.train, np.random.default_rng(base * 1_000_003 + s))
                        for s in slots]

            nxt = submit(0)
            for b in range(self.batches_per_epoch):
                futs = nxt
                if b + 1 < self.batches_per_epoch:
                    nxt = submit(b + 1)
                out = [f.result() for f in futs]
                yield {"img": np.stack([o["img"] for o in out]), "label": np.stack([o["label"] for o in out])}


def classification_data(root) -> Dict:
    """The data descriptor of an image folder (`root/train/<class>/`, and
    `root/val/` where it exists): path, nc, names from train's class folders."""
    root = Path(root)
    classes = sorted(d.name for d in (root / "train").iterdir() if d.is_dir())
    return {"path": str(root), "nc": len(classes), "names": dict(enumerate(classes)),
            "train": str(root / "train"), "val": str(root / "val") if (root / "val").is_dir() else None}


# ---------------------------------------------------------------------------------------------------------------
# the classify transforms (the JAX package's data/transforms.py:378-465)


class ClassifyLetterBox:
    """The image scaled to fit a size x size canvas of grey 114, centred."""

    def __init__(self, size=224):
        self.h = self.w = size if isinstance(size, int) else size[0]

    def __call__(self, im: np.ndarray) -> np.ndarray:
        h, w = im.shape[:2]
        r = min(self.h / h, self.w / w)
        nh, nw = round(h * r), round(w * r)
        top, left = (self.h - nh) // 2, (self.w - nw) // 2
        out = np.full((self.h, self.w, 3), 114, im.dtype)
        out[top:top + nh, left:left + nw] = resize(im, nh, nw)
        return out


class CenterCrop:
    """The centred square of the shorter side, resized to size x size."""

    def __init__(self, size=224):
        self.h = self.w = size if isinstance(size, int) else size[0]

    def __call__(self, im: np.ndarray) -> np.ndarray:
        h, w = im.shape[:2]
        m = min(h, w)
        top, left = (h - m) // 2, (w - m) // 2
        return resize(im[top:top + m, left:left + m], self.h, self.w)


class ToTensor:
    """HWC BGR uint8 -> CHW RGB float in [0, 1] (float16 with half), a numpy array."""

    def __init__(self, half: bool = False):
        self.half = half

    def __call__(self, im: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(im[..., ::-1].transpose(2, 0, 1)).astype(
            np.float16 if self.half else np.float32) / 255.0


class Compose:
    def __init__(self, transforms: List[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


def classify_augmentations(size: int = 224, scale=(0.08, 1.0), hflip: float = 0.5, erasing: float = 0.0,
                           mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0), rng: Optional[np.random.Generator] = None,
                           **_ignored) -> Compose:
    """The train-time pipeline: a random resized crop (area `scale`, aspect
    3/4 to 4/3, ten tries, else CenterCrop), a left-right flip at hflip,
    erasing of a rectangle with random pixels at `erasing`, ToTensor, then
    (x - mean) / std. Draws from `rng` (default: a fresh unseeded one, as the
    JAX package's)."""
    rng = rng if rng is not None else np.random.default_rng()
    mean_a = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std_a = np.asarray(std, np.float32).reshape(3, 1, 1)

    def rrc(im):
        h, w = im.shape[:2]
        for _ in range(10):
            a = rng.uniform(*scale) * h * w
            ar = math.exp(rng.uniform(math.log(3 / 4), math.log(4 / 3)))
            cw, ch = int(round(math.sqrt(a * ar))), int(round(math.sqrt(a / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                x0, y0 = rng.integers(0, w - cw + 1), rng.integers(0, h - ch + 1)
                return resize(im[y0:y0 + ch, x0:x0 + cw], size, size)
        return CenterCrop(size)(im)

    def flip(im):
        return np.ascontiguousarray(im[:, ::-1]) if rng.random() < hflip else im

    def erase(im):
        if erasing and rng.random() < erasing:
            h, w = im.shape[:2]
            eh, ew = int(h * rng.uniform(0.02, 0.33) ** 0.5), int(w * rng.uniform(0.02, 0.33) ** 0.5)
            y0, x0 = rng.integers(0, max(h - eh, 1)), rng.integers(0, max(w - ew, 1))
            im = im.copy()
            im[y0:y0 + eh, x0:x0 + ew] = rng.integers(0, 256, (eh, ew, im.shape[2]), dtype=im.dtype)
        return im

    return Compose([rrc, flip, erase, ToTensor(), lambda chw: (chw - mean_a) / std_a])


def classify_transforms(size: int = 224, crop_fraction: float = 1.0, **_ignored) -> Compose:
    """The eval-time pipeline: CenterCrop(size / crop_fraction), then ToTensor."""
    return Compose([CenterCrop(int(size / crop_fraction)), ToTensor()])
