"""YOLO-format detection dataset and its batch loader (counterpart of the
JAX package's data/dataset.py: check_det_dataset, YOLODataset, DataLoader).

  * labels are parsed and verified up front into memory, through the
    hash-keyed `labels/<split>.cache` that the JAX package also reads;
  * the image cache: cache=True or 'ram' keeps decoded frames in memory and
    hands out copies, 'disk' writes a sibling `.npy` of each image (the JAX
    package's names, so each package reads the other's);
  * the loader decodes and transforms in a thread pool and yields
    fixed-shape numpy batches: img (B, H, W, 3) uint8 RGB, cls (B, G),
    bboxes (B, G, 4) normalised xywh, mask (B, G), plus ratio_pad and
    orig_shape on the val path (the segment task: `seg_map`, the instances'
    overlap map or bit planes, and ratio_pad, from data/augment.py
    segment_transform on both paths; the pose task: `kpts` (B, max_gt, nk,
    3), from data/augment.py pose_transform, the train path swapping left
    and right points on a flip by the descriptor's `flip_idx`; the OBB
    task: `bboxes` (B, max_gt, 5) normalised xywh and the angle in radians,
    each 4-corner polygon label's minimum-area rectangle, from
    data/augment.py obb_transform). The train path either letterboxes only and
    adds `aug` (the 7 device-augmentation hyperparameters in AUG_KEYS
    order; device_augment=True, the default) or runs the host augmentation
    stack (data/augment.py train_transform; device_augment=False), each
    sample from its own generator seeded by (seed, epoch, image, position
    in the epoch), with the JAX package's draws of the mosaic and mixup donors;
  * batch i of epoch e is a pure function of (seed, e, i): the epoch's
    permutation is default_rng(seed + epoch), and a short last batch wraps
    around to the first images (on the val path too, as in the JAX package,
    whose metrics then count those images twice). The next batch is
    submitted to the pool before the current one is yielded, so decoding
    overlaps the step.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import os
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import yaml

from ..cfg import AUG_KEYS
from ..utils.patches import image_size, imread
from .augment import (obb_transform, pose_transform, raw_train_transform, segment_transform, train_transform,
                      val_transform)
from .utils import load_or_build_cache

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
DATASETS_DIR = Path(__file__).resolve().parent.parent / "cfg" / "datasets"
AUG_DEFAULTS = {"mosaic": 1.0, "scale": 0.5, "translate": 0.1, "fliplr": 0.5, "hsv_h": 0.015, "hsv_s": 0.7,
                "hsv_v": 0.4}


def check_det_dataset(data) -> Dict:
    """A data YAML (path) or dict with absolute split paths, names as a
    dict and nc. A bare YAML name that is not a file (`"coco8.yaml"`) is
    read from the packaged cfg/datasets/, and its relative `path:` is
    anchored at SETTINGS["datasets_dir"]; a user YAML's relative `path:` is
    anchored at the YAML's directory. A pose descriptor's `kpt_shape` and
    `flip_idx` pass through. Nothing is downloaded."""
    packaged = False
    if isinstance(data, (str, Path)):
        p = Path(data)
        if not p.exists() and p.suffix in (".yaml", ".yml") and len(p.parts) == 1:
            cand = DATASETS_DIR / p.name
            if cand.exists():
                p, packaged = cand, True
        data = yaml.safe_load(p.read_text()) | {"yaml_file": str(p)}
    root = Path(data.get("path", "."))
    if not root.is_absolute():
        if packaged:
            from ..utils.settings import SETTINGS

            root = Path(SETTINGS["datasets_dir"]) / root
        elif "yaml_file" in data:
            root = Path(data["yaml_file"]).parent / root
    out = dict(data)
    for split in ("train", "val", "test"):
        if data.get(split):
            p = Path(data[split])
            out[split] = str(p if p.is_absolute() else root / p)
    names = data.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    out["names"] = names or {i: str(i) for i in range(data.get("nc", 80))}
    out["nc"] = data.get("nc", len(out["names"]))
    return out


class YOLODataset:
    """Images and YOLO txt labels of one split; with kpt_shape (nk, nd) a
    pose dataset's, its keypoints read by that shape, and `flip_idx` the
    keypoint order of a left-right flip (None: the points keep their order)."""

    def __init__(self, img_dir: str, imgsz: int = 640, max_gt: int = 300, nc: int = 80, single_cls: bool = False,
                 fraction: float = 1.0, cache=False, kpt_shape=None, flip_idx=None):
        self.cache = "ram" if cache is True else (str(cache).lower() if cache else None)
        if self.cache not in (None, "ram", "disk"):
            raise ValueError(f"cache={cache!r} must be True/'ram', 'disk' or False")
        self._ram: Dict[int, np.ndarray] = {}
        self._ram_lock = threading.Lock()
        self.img_dir = Path(img_dir)
        self.imgsz = imgsz
        self.max_gt = max_gt
        self.nc = nc
        self.single_cls = single_cls
        self.kpt_shape = tuple(kpt_shape) if kpt_shape else None
        self.flip_idx = list(flip_idx) if flip_idx is not None and self.kpt_shape else None
        self.img_files = sorted(str(p) for p in self.img_dir.rglob("*") if p.suffix.lower() in IMG_EXTS)
        if not self.img_files:
            raise FileNotFoundError(f"no images found under {img_dir}")
        if fraction < 1.0:
            self.img_files = self.img_files[: max(1, round(len(self.img_files) * fraction))]
        self.labels, self.stats = load_or_build_cache(self.img_files, nc, self.kpt_shape, single_cls)
        if self.stats.get("ncorrupt"):
            bad = self.stats["msgs"][:3]
            raise ValueError(f"{self.stats['ncorrupt']} corrupt images/labels under {img_dir}: {bad}")

    def rect_shape(self, stride: int = 32):
        """One stride-multiple (h, w) letterbox shape for the whole split, from
        the median aspect ratio of its first 64 images, with the reference's
        half-stride bump on both sides."""
        ars = []
        for f in self.img_files[:64]:
            w, h, _ = image_size(f)
            ars.append(h / w)
        ar = float(np.median(ars))
        h = math.ceil(min(ar, 1.0) * self.imgsz / stride + 0.5) * stride
        w = math.ceil(min(1.0 / ar, 1.0) * self.imgsz / stride + 0.5) * stride
        return (h, w)

    def __len__(self):
        return len(self.img_files)

    def _read_image(self, idx: int) -> np.ndarray:
        """Decode one frame through the cache; the RAM cache hands out copies,
        which the transforms may change in place."""
        if self.cache == "ram":
            with self._ram_lock:
                hit = self._ram.get(idx)
            if hit is not None:
                return hit.copy()
        elif self.cache == "disk":
            npy = Path(self.img_files[idx]).with_suffix(".npy")
            if npy.exists():
                return np.load(npy)
        img = imread(self.img_files[idx])
        if img is None:
            raise IOError(f"failed to read {self.img_files[idx]}")
        if self.cache == "ram":
            with self._ram_lock:
                self._ram[idx] = img
            return img.copy()
        if self.cache == "disk":  # written aside, then renamed: another thread may read the .npy at any time
            npy = Path(self.img_files[idx]).with_suffix(".npy")
            tmp = npy.with_name(f".{npy.name}.{threading.get_ident()}.tmp")
            with open(tmp, "wb") as fh:
                np.save(fh, img)
            os.replace(tmp, npy)
        return img

    def load_sample(self, idx: int) -> Dict:
        """Raw sample: BGR image, pixel xyxy boxes, classes, each label's
        normalised polygon (None for a box row) and keypoints (None where it
        has none)."""
        img = self._read_image(idx)
        h, w = img.shape[:2]
        lab = self.labels[idx]
        xywhn = lab["xywhn"]
        if len(xywhn):
            cx, cy, bw, bh = xywhn[:, 0] * w, xywhn[:, 1] * h, xywhn[:, 2] * w, xywhn[:, 3] * h
            bboxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], axis=1).astype(np.float32)
        else:
            bboxes = np.zeros((0, 4), np.float32)
        return {"img": img, "bboxes": bboxes, "cls": lab["cls"].copy(), "segments": lab.get("segments", []),
                "kpts": lab.get("kpts", [])}


class DataLoader:
    """Deterministic thread-prefetch loader of fixed-shape batches."""

    def __init__(self, dataset: YOLODataset, batch_size: int, train: bool = True, hyp: Optional[Dict] = None,
                 seed: int = 0, workers: int = 8, device_augment: bool = True,
                 rect_shape=None, task: str = "detect"):
        self.ds = dataset
        self.bs = batch_size
        self.train = train
        self.task = task
        # the segment, pose and OBB tasks run their own host stack, never the device augmentation nor rect, as
        # in the JAX package
        self.device_augment = device_augment and train and task == "detect"
        self.rect_shape = tuple(rect_shape) if rect_shape and task == "detect" else None  # val only: (h, w)
        self.hyp = dict(hyp or {})
        self.seed = seed
        self.epoch = 0
        n = len(dataset)
        self.batches_per_epoch = max(1, n // batch_size) if train else int(np.ceil(n / batch_size))
        self.workers = max(1, workers)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def close_mosaic(self):
        """Mosaic off for the final epochs."""
        self.hyp["mosaic"] = 0.0

    def _indices(self):
        n = len(self.ds)
        return np.random.default_rng(self.seed + self.epoch).permutation(n) if self.train else np.arange(n)

    def _make_sample(self, epoch: int, pos: int, i: int) -> Dict[str, np.ndarray]:
        """Image i at position pos of the epoch. The host path's generator and
        donor draws are the JAX package's (its DataLoader._make_sample)."""
        if self.task in ("segment", "pose", "obb"):
            rng = np.random.default_rng((self.seed * 1_000_003 + epoch) * 1_000_003 + i * 7 + pos)
            group = self.ds.load_sample(i)
            if self.train:  # the main sample, the 2x2 mosaic's donors, with mixup a second mosaic's, and in
                # copy_paste's mixup mode four more for its donor mosaic, in one draw as the JAX loader makes it
                n = 7 if self.hyp.get("mixup", 0.0) > 0 else 3
                if str(self.hyp.get("copy_paste_mode", "flip")) == "mixup" and self.hyp.get("copy_paste", 0.0) > 0:
                    n += 4
                extra = rng.integers(0, len(self.ds), n)
                group = [group] + [self.ds.load_sample(int(j)) for j in extra]
            if self.task == "pose":
                return pose_transform(group, self.ds.imgsz, self.ds.max_gt, self.ds.kpt_shape or (17, 3), self.train,
                                      rng, self.hyp, flip_idx=self.ds.flip_idx)
            if self.task == "obb":  # the polygons of the 4-corner labels, read as segments
                return obb_transform(group, self.ds.imgsz, self.ds.max_gt, self.train, rng, self.hyp)
            return segment_transform(group, self.ds.imgsz, self.ds.max_gt, self.train, rng, self.hyp)
        if self.device_augment:
            return raw_train_transform(self.ds.load_sample(i), self.ds.imgsz, self.ds.max_gt)
        if self.train:
            rng = np.random.default_rng((self.seed * 1_000_003 + epoch) * 1_000_003 + i * 7 + pos)
            base = 8 if self.hyp.get("mosaic9", 0.0) > 0 else 3  # the 3x3 or 2x2 grid's donors
            extra = rng.integers(0, len(self.ds), base + (4 if self.hyp.get("mixup", 0.0) > 0 else 0))
            samples = [self.ds.load_sample(i)] + [self.ds.load_sample(int(j)) for j in extra]
            return train_transform(samples, self.ds.imgsz, self.ds.max_gt, rng, self.hyp)
        return val_transform(self.ds.load_sample(i), self.ds.imgsz, self.ds.max_gt, shape=self.rect_shape)

    def __len__(self):
        return self.batches_per_epoch

    def __iter__(self):
        """One epoch; the worker threads live as long as the iteration."""
        idx = self._indices()
        n = len(idx)
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            def submit(b):
                return [pool.submit(self._make_sample, self.epoch, b * self.bs + j, int(idx[(b * self.bs + j) % n]))
                        for j in range(self.bs)]

            nxt = submit(0)
            for b in range(self.batches_per_epoch):
                futs = nxt
                if b + 1 < self.batches_per_epoch:
                    nxt = submit(b + 1)
                samples = [f.result() for f in futs]
                batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                if self.device_augment:
                    batch["aug"] = np.asarray([self.hyp.get(k, AUG_DEFAULTS[k]) for k in AUG_KEYS], np.float32)
                yield batch
