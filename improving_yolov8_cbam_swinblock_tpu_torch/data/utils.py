"""Dataset verification and the label cache (counterpart of the JAX package's data/utils.py:22-170).

verify_image_label checks one image/label pair (image size and format from
its header, label rows, coordinate ranges; a pose dataset's keypoints by its
kpt_shape) and load_or_build_cache keeps the verified labels of a split in a
hash-keyed `labels/<split>.cache` pickle, with the JAX package's payload and
CACHE_VERSION, so that either package reads the other's cache. The JAX
package keys that cache without kpt_shape, so a cache written for detection
holds no keypoints: read for a pose dataset, such a cache is rebuilt.
"""

from __future__ import annotations

import hashlib
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

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


def verify_image_label(im_file: str, lb_file: str, num_cls: int, kpt_shape: Optional[Sequence[int]] = None,
                       single_cls: bool = False) -> Dict:
    """Verify one pair; returns the parsed label dict and its status (nm
    missing, nf found, ne empty, ncorrupt). A corrupt image or an
    out-of-range class marks ncorrupt; segment rows become their boxes.
    With kpt_shape (nk, nd), a row of 5 + nk * nd values is a box and its
    keypoints, (nk, 3) float32 normalised x, y and the visibility; at nd 2
    the visibility is appended, 0 where x or y is negative, else 1, as the
    reference reads them (the JAX package reads any row of 5 + 3k values as
    k points of three, so it cannot read 2-D keypoints). A row of another
    length beside keypoint rows marks ncorrupt, as in the reference."""
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

    cls, boxes, segments, kpts = [], [], [], []
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
            if kpt_shape and len(vals) > 5:
                nk, nd = kpt_shape
                if len(vals) != 5 + nk * nd:
                    out.update(ncorrupt=1, msg=f"labels require {5 + nk * nd} columns each for kpt_shape "
                                                f"{list(kpt_shape)}: {len(vals)} in {lb_file}")
                    return out
                x, y, bw, bh = map(float, vals[1:5])
                k = np.asarray([float(v) for v in vals[5:]], np.float32).reshape(nk, nd)
                if nd == 2:
                    vis = np.where((k[:, 0] < 0) | (k[:, 1] < 0), 0.0, 1.0).astype(np.float32)
                    k = np.concatenate([k, vis[:, None]], 1)
                if bw > 0 and bh > 0:
                    cls.append(c)
                    boxes.append([x, y, bw, bh])
                    segments.append(None)
                    kpts.append(k)
                continue
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
                    kpts.append(None)
            elif len(vals) >= 5:
                x, y, bw, bh = map(float, vals[1:5])
                if not (0 <= x <= 1 and 0 <= y <= 1 and bw <= 1 and bh <= 1):
                    out["msg"] = f"non-normalized box coords in {lb_file}"
                if bw > 0 and bh > 0:
                    cls.append(c)
                    boxes.append([x, y, bw, bh])
                    segments.append(None)
                    kpts.append(None)
        if lines and not out["ne"]:
            out["nf"] = 1
    out["label"] = {
        "cls": np.asarray(cls, np.float32),
        "xywhn": np.asarray(boxes, np.float32).reshape(-1, 4),
        "segments": segments,
        "kpts": kpts,
    }
    return out


def _has_keypoints(labels: List[Dict], kpt_shape: Sequence[int]) -> bool:
    """Every instance of the cached labels has (nk, 3) keypoints."""
    for lab in labels:
        kp = list(lab.get("kpts") or [])
        if len(kp) != len(lab["cls"]) or any(k is None or np.shape(k) != (kpt_shape[0], 3) for k in kp):
            return False
    return True


def load_or_build_cache(img_files: List[str], num_cls: int, kpt_shape: Optional[Sequence[int]] = None,
                        single_cls: bool = False) -> Tuple[List[Dict], Dict]:
    """Verified labels for a split, read from the sibling .cache file when
    its version and hash still match (and, with kpt_shape, when every
    instance in it has its (nk, 3) keypoints), else rebuilt and written there."""
    lb_files = img_label_paths(img_files)
    key = dataset_hash(img_files + lb_files)
    cache_path = Path(lb_files[0]).parent.with_suffix(".cache") if lb_files else None

    if cache_path and cache_path.exists():
        try:
            payload = pickle.loads(cache_path.read_bytes())
            if payload.get("version") == CACHE_VERSION and payload.get("hash") == key and (
                    not kpt_shape or _has_keypoints(payload["labels"], kpt_shape)):
                return payload["labels"], payload["stats"]
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError, TypeError):
            pass  # stale or corrupt cache: rebuild

    labels, stats = [], {"nm": 0, "nf": 0, "ne": 0, "ncorrupt": 0, "msgs": []}
    for im, lb in zip(img_files, lb_files):
        r = verify_image_label(im, lb, num_cls, kpt_shape, single_cls)
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
