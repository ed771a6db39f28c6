"""Dataset verification and the label cache (counterpart of the JAX package's data/utils.py:22-170).

verify_image_label checks one image/label pair (image size and format from
its header, label rows, coordinate ranges) and load_or_build_cache keeps the
verified labels of a split in a hash-keyed `labels/<split>.cache` pickle,
with the JAX package's payload and CACHE_VERSION, so that either package
reads the other's cache.
"""

from __future__ import annotations

import hashlib
import pickle
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..utils.patches import image_size

CACHE_VERSION = "0.2"
IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tiff", "webp", "mpo"}


def img_label_paths(img_files: List[str]) -> List[str]:
    """images/ -> labels/ path swap on the last 'images' component."""
    out = []
    for img_path in img_files:
        parts = list(Path(img_path).parts)
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] == "images":
                parts[i] = "labels"
                break
        out.append(str(Path(*parts).with_suffix(".txt")))
    return out


def dataset_hash(paths: List[str]) -> str:
    """Size-based content hash of every file in the split."""
    h = hashlib.sha256()
    total = 0
    for p in paths:
        try:
            total += Path(p).stat().st_size
        except OSError:
            pass
        h.update(str(p).encode())
    h.update(str(total).encode())
    return h.hexdigest()


def verify_image_label(im_file: str, lb_file: str, num_cls: int, single_cls: bool = False) -> Dict:
    """Verify one pair; returns the parsed label dict and its status (nm
    missing, nf found, ne empty, ncorrupt). A corrupt image or an
    out-of-range class marks ncorrupt; segment rows become their boxes."""
    out = {"nm": 0, "nf": 0, "ne": 0, "ncorrupt": 0, "msg": ""}
    try:
        w, h, fmt = image_size(im_file)
        if w < 10 or h < 10:
            raise ValueError(f"image too small {(w, h)}")
        if fmt not in IMG_FORMATS:
            raise ValueError(f"invalid format {fmt}")
    except (OSError, ValueError) as e:
        out.update(ncorrupt=1, msg=f"corrupt image {im_file}: {e}")
        return out

    cls, boxes, segments = [], [], []
    lp = Path(lb_file)
    if not lp.exists():
        out["nm"] = 1
    else:
        lines = lp.read_text().strip().splitlines()
        if not lines:
            out["ne"] = 1
        for line in lines:
            vals = line.split()
            c = 0 if single_cls else int(float(vals[0]))
            if c >= num_cls:
                out["msg"] = f"label class {c} exceeds nc={num_cls} in {lb_file}"
                out["ncorrupt"] = 1
                return out
            if len(vals) > 5 and len(vals) % 2 == 1:
                poly = np.asarray([float(v) for v in vals[1:]], np.float32).reshape(-1, 2)
                if ((poly < -0.01) | (poly > 1.01)).any():
                    out["msg"] = f"non-normalized segment coords in {lb_file}"
                x1, y1 = poly.min(0)
                x2, y2 = poly.max(0)
                if x2 > x1 and y2 > y1:
                    cls.append(c)
                    boxes.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
                    segments.append(poly)
            elif len(vals) >= 5:
                x, y, bw, bh = map(float, vals[1:5])
                if not (0 <= x <= 1 and 0 <= y <= 1 and bw <= 1 and bh <= 1):
                    out["msg"] = f"non-normalized box coords in {lb_file}"
                if bw > 0 and bh > 0:
                    cls.append(c)
                    boxes.append([x, y, bw, bh])
                    segments.append(None)
        if lines and not out["ne"]:
            out["nf"] = 1
    out["label"] = {
        "cls": np.asarray(cls, np.float32),
        "xywhn": np.asarray(boxes, np.float32).reshape(-1, 4),
        "segments": segments,
        "kpts": [None] * len(cls),  # the JAX package's cache payload; the port reads no keypoints
    }
    return out


def load_or_build_cache(img_files: List[str], num_cls: int, single_cls: bool = False) -> Tuple[List[Dict], Dict]:
    """Verified labels for a split, read from the sibling .cache file when
    its version and hash still match, else rebuilt and written there."""
    lb_files = img_label_paths(img_files)
    key = dataset_hash(img_files + lb_files)
    cache_path = Path(lb_files[0]).parent.with_suffix(".cache") if lb_files else None

    if cache_path and cache_path.exists():
        try:
            payload = pickle.loads(cache_path.read_bytes())
            if payload.get("version") == CACHE_VERSION and payload.get("hash") == key:
                return payload["labels"], payload["stats"]
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError, TypeError):
            pass  # stale or corrupt cache: rebuild

    labels, stats = [], {"nm": 0, "nf": 0, "ne": 0, "ncorrupt": 0, "msgs": []}
    for im, lb in zip(img_files, lb_files):
        r = verify_image_label(im, lb, num_cls, single_cls)
        for k in ("nm", "nf", "ne", "ncorrupt"):
            stats[k] += r[k]
        if r["msg"]:
            stats["msgs"].append(r["msg"])
        labels.append(r.get("label", {"cls": np.zeros(0, np.float32), "xywhn": np.zeros((0, 4), np.float32),
                                      "segments": [], "kpts": []}))
    if cache_path:
        try:
            cache_path.write_bytes(pickle.dumps({"version": CACHE_VERSION, "hash": key, "labels": labels,
                                                 "stats": stats}))
        except OSError:
            pass  # read-only label dir: caching is best-effort
    return labels, stats
