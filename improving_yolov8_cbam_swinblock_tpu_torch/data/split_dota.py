"""DOTA tiling: large aerial scenes cut into overlapping square crops with their OBB labels.

The port's copy of the JAX package's data/split_dota.py. `get_windows`
lays windows of each crop size over an image with a step of crop - gap,
the last one in each direction flush with the image's edge, and keeps the
windows whose share of image content exceeds im_rate_thr (the fullest one
where none does). `bbox_iof` is the intersection of each polygon's
axis-aligned box with each window over that box's area.
`split_images_and_labels` writes, for each window, the crop and the
labels (YOLO-OBB corner rows, shifted and normalised to the crop) of the
objects whose IoF with it reaches iof_thr, as `<stem>__<x0>__<y0>`; a crop
without a label is not written. Images are read with utils/patches.py
imread (cv2, PIL or the port's PNG decoder) and written with cv2.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..utils.patches import imread

IMG_SUFFIXES = {".png", ".jpg", ".jpeg", ".bmp"}


def bbox_iof(polygon1: np.ndarray, bbox2: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """(n, 8) polygons' corners and (m, 4) xyxy windows -> (n, m): the
    intersection of each polygon's box with each window over the box's area."""
    pts = polygon1.reshape(-1, 4, 2)
    lt, rb = pts.min(1), pts.max(1)
    tl = np.maximum(lt[:, None], bbox2[None, :, :2])
    br = np.minimum(rb[:, None], bbox2[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    return inter / (np.prod(rb - lt, axis=1)[:, None] + eps)


def get_windows(im_size: Tuple[int, int], crop_sizes=(1024,), gaps=(200,), im_rate_thr: float = 0.6) -> np.ndarray:
    """The (k, 4) xyxy windows over an (h, w) image (the module docstring)."""
    h, w = im_size
    windows = []
    for crop, gap in zip(crop_sizes, gaps):
        step = crop - gap
        xn = 1 if w <= crop else int(np.ceil((w - crop) / step + 1))
        yn = 1 if h <= crop else int(np.ceil((h - crop) / step + 1))
        xs = [min(step * i, max(w - crop, 0)) for i in range(xn)]
        ys = [min(step * i, max(h - crop, 0)) for i in range(yn)]
        windows += [[x0, y0, x0 + crop, y0 + crop] for y0 in ys for x0 in xs]
    windows = np.asarray(windows, np.float64)
    clipped = windows.copy()
    clipped[:, 0::2] = clipped[:, 0::2].clip(0, w)
    clipped[:, 1::2] = clipped[:, 1::2].clip(0, h)
    rates = np.prod(clipped[:, 2:] - clipped[:, :2], 1) / np.prod(windows[:, 2:] - windows[:, :2], 1)
    if not (rates > im_rate_thr).any():
        rates[rates.argmax()] = 1.0
    return windows[rates > im_rate_thr]


def split_images_and_labels(data_root: str, save_dir: str, split: str = "train", crop_sizes=(1024,), gaps=(200,),
                            iof_thr: float = 0.7) -> List[str]:
    """Tile every image of <data_root>/images/<split> and its labels into
    <save_dir>/images/<split> and <save_dir>/labels/<split>; returns the
    written crops' names in order."""
    import cv2

    root, save = Path(data_root), Path(save_dir)
    im_out, lb_out = save / "images" / split, save / "labels" / split
    im_out.mkdir(parents=True, exist_ok=True)
    lb_out.mkdir(parents=True, exist_ok=True)
    written = []
    for imf in sorted((root / "images" / split).iterdir()):
        if imf.suffix.lower() not in IMG_SUFFIXES:
            continue
        img = imread(imf)
        h, w = img.shape[:2]
        lf = root / "labels" / split / f"{imf.stem}.txt"
        rows = []
        if lf.exists():
            for line in lf.read_text().strip().splitlines():
                vals = line.split()
                pts = np.asarray([float(v) for v in vals[1:9]], np.float64)
                pts[0::2] *= w
                pts[1::2] *= h
                rows.append((int(float(vals[0])), pts))
        polys = np.stack([p for _, p in rows]) if rows else np.zeros((0, 8))
        windows = get_windows((h, w), crop_sizes, gaps)
        iof = bbox_iof(polys, windows) if rows else np.zeros((0, len(windows)))
        for wi, (x0, y0, x1, y1) in enumerate(windows.astype(int)):
            crop = img[y0:min(y1, h), x0:min(x1, w)]
            ch, cw = crop.shape[:2]
            lines = []
            for ri, (cls, pts) in enumerate(rows):
                if iof[ri, wi] >= iof_thr:
                    q = pts.copy()
                    q[0::2] = (q[0::2] - x0) / cw
                    q[1::2] = (q[1::2] - y0) / ch
                    lines.append(f"{cls} " + " ".join(f"{v:.6g}" for v in q))
            if not lines:
                continue
            name = f"{imf.stem}__{x0}__{y0}"
            cv2.imwrite(str(im_out / f"{name}{imf.suffix}"), crop)
            (lb_out / f"{name}.txt").write_text("\n".join(lines) + "\n")
            written.append(name)
    return written


def split_trainval(data_root: str, save_dir: str, crop_size: int = 1024, gap: int = 200) -> None:
    """Tile the train and val splits of data_root that exist."""
    for split in ("train", "val"):
        if (Path(data_root) / "images" / split).exists():
            split_images_and_labels(data_root, save_dir, split, (crop_size,), (gap,))
