"""Inference results of the predict path: numpy-backed, like the JAX
package's engine/results.py (its detection part, the masks of a
segmentation model, the keypoints of a pose model and the oriented boxes
of an OBB model).

`Results` holds one image's detections and writes them out: a log string
(`verbose`), dicts and JSON (`summary`, `to_json`, with each mask's polygon
as `segments` and each detection's `keypoints`), a sqlite table
(`to_sql`), an annotated copy of the image with the masks blended in and
the keypoints dotted (`plot`, `save`, `show`), YOLO label lines
(`save_txt`, a pose model's normalised keypoints after each box, an OBB
model's normalised corners) and crops (`save_crop`). Drawing and image files need cv2, as
in the JAX package; the polygons (`Masks.xy`) do not.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np


class Boxes:
    """Detections (n, 6) [x1, y1, x2, y2, conf, cls], or (n, 7) with a track
    id column [x1, y1, x2, y2, id, conf, cls], in original image pixels."""

    def __init__(self, data: np.ndarray, orig_shape):
        data = np.asarray(data, dtype=np.float32)
        self.data = data.reshape(-1, data.shape[-1] if data.ndim > 1 and data.shape[-1] == 7 else 6)
        self.orig_shape = tuple(orig_shape)
        self.is_track = self.data.shape[-1] == 7

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        """Track ids, or None for plain detections."""
        return self.data[:, 4] if self.is_track else None

    @property
    def xywh(self):
        b = self.data[:, :4]
        return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2, b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.array([w, h, w, h], np.float32)

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.array([w, h, w, h], np.float32)

    def __getitem__(self, idx):
        return Boxes(np.atleast_2d(self.data[idx]), self.orig_shape)

    def __len__(self):
        return len(self.data)


class Masks:
    """Instance masks: (n, H, W) bool at the original image's resolution,
    array-like (len, iteration, indexing and __array__), as the JAX
    package's engine/results.py Masks."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data)
        self.orig_shape = tuple(orig_shape)

    @property
    def xy(self):
        """Each mask's largest outer contour (utils/patches.py find_contours,
        the first of equal areas) as a (k, 2) float32 polygon in original
        pixels, scaled from the mask's resolution where it differs; (0, 2)
        for an empty mask."""
        from ..ops.segments import masks2segments

        out = []
        for m, c in zip(self.data, masks2segments(self.data, "largest")):
            if len(c):
                c *= np.array([self.orig_shape[1] / m.shape[1], self.orig_shape[0] / m.shape[0]], np.float32)
            out.append(c)
        return out

    @property
    def xyn(self):
        """xy normalised by the original image's width and height."""
        h, w = self.orig_shape
        return [p / np.array([w, h], np.float32) for p in self.xy]

    @property
    def shape(self):
        return self.data.shape

    def __array__(self, dtype=None, copy=None):
        return self.data.astype(dtype) if dtype is not None else self.data

    def __iter__(self):
        return iter(self.data)

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class Keypoints:
    """Pose keypoints: (n, nk, nd) float32, x and y in original image pixels
    and, where nd is 3, the visibility score, as the JAX package's
    engine/results.py Keypoints."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, dtype=np.float32)
        self.orig_shape = tuple(orig_shape)

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        """xy normalised by the original image's width and height."""
        h, w = self.orig_shape
        return self.xy / np.array([w, h], np.float32)

    @property
    def conf(self):
        """The visibility scores (n, nk), or None where nd is 2."""
        return self.data[..., 2] if self.data.shape[-1] == 3 else None

    @property
    def shape(self):
        return self.data.shape

    def __len__(self):
        return len(self.data)


class OBB:
    """Oriented boxes: (n, 7) float32 [x, y, w, h, angle, conf, cls] in
    original image pixels and radians, or (n, 8) with a track id before
    conf, as the JAX package's engine/results.py OBB."""

    def __init__(self, data: np.ndarray, orig_shape):
        data = np.asarray(data, dtype=np.float32)
        n = data.shape[-1] if data.size else 7
        self.data = data.reshape(-1, n)
        self.is_track = n == 8
        self.orig_shape = tuple(orig_shape)

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def id(self):
        """Track ids, or None for plain detections."""
        return self.data[:, 5] if self.is_track else None

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def xyxyxyxy(self):
        """The 4 corners (n, 4, 2) of each box."""
        x, y, w, h, r = (self.data[:, i] for i in range(5))
        c, s = np.cos(r), np.sin(r)
        vx = np.stack([w / 2 * c, w / 2 * s], -1)
        vy = np.stack([-h / 2 * s, h / 2 * c], -1)
        ctr = self.data[:, :2]
        return np.stack([ctr + vx + vy, ctr + vx - vy, ctr - vx - vy, ctr - vx + vy], axis=1)

    @property
    def xyxy(self):
        """The enclosing axis-aligned boxes (n, 4)."""
        pts = self.xyxyxyxy
        return np.concatenate([pts.min(1), pts.max(1)], axis=-1)

    def __len__(self):
        return len(self.data)


class Probs:
    """A classify model's class probabilities (nc,) float32 (the JAX
    package's Probs): top1, top5 (np.argsort of the negated probabilities:
    the JAX package's ranking), top1conf, top5conf."""

    def __init__(self, data, orig_shape=None):
        self.data = np.asarray(data, np.float32).reshape(-1)
        self.orig_shape = orig_shape

    @property
    def top1(self) -> int:
        return int(np.argmax(self.data))

    @property
    def top5(self) -> list:
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data[self.top1])

    @property
    def top5conf(self) -> np.ndarray:
        return self.data[self.top5]

    def __array__(self, dtype=None, copy=None):
        return self.data.astype(dtype) if dtype is not None else self.data

    def __len__(self):
        return len(self.data)


def _class_color(cls: int) -> tuple:
    """The JAX package's Results.plot colour of a class (BGR)."""
    return tuple(int(v) for v in np.array([37, 255, 225]) * ((cls % 5 + 1) / 5))


class Results:
    """One image's detections, a segmentation model's masks (`masks`), a
    pose model's keypoints (`keypoints`) and an oriented-box model's
    rotated boxes (`obb`, with `boxes` their enclosing axis-aligned boxes)
    and a classify model's class probabilities (`probs`, no boxes), each
    None otherwise."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str], boxes: Optional[np.ndarray] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes if boxes is not None else np.zeros((0, 6)), self.orig_shape)
        self.masks: Optional[Masks] = None
        self.keypoints: Optional[Keypoints] = None
        self.obb: Optional[OBB] = None
        self.probs: Optional[Probs] = None
        self.speed = {"preprocess": None, "inference": None, "postprocess": None}

    def __len__(self):
        return len(self.boxes)

    def __getitem__(self, idx):
        """A new Results over the selected detections (and their masks and keypoints)."""
        r = self.new()
        r.boxes = self.boxes[idx]
        if self.masks is not None:
            m = self.masks.data[idx]
            r.masks = Masks(m[None] if m.ndim == 2 else m, self.orig_shape)
        if self.keypoints is not None:
            k = self.keypoints.data
            r.keypoints = Keypoints(k[idx].reshape((-1,) + k.shape[1:]), self.orig_shape)
        if self.obb is not None:
            r.obb = OBB(np.atleast_2d(self.obb.data[idx]), self.orig_shape)
        return r

    def new(self):
        """Empty Results over the same image."""
        r = Results(self.orig_img, self.path, self.names)
        r.speed = dict(self.speed)
        return r

    def update(self, boxes=None, masks=None, keypoints=None, obb=None, probs=None):
        """Replace the detections (and the masks, the keypoints, the oriented boxes, the probabilities) in place."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        if masks is not None:
            self.masks = Masks(masks, self.orig_shape)
        if keypoints is not None:
            self.keypoints = Keypoints(keypoints, self.orig_shape)
        if obb is not None:
            self.obb = OBB(obb, self.orig_shape)
        if probs is not None:
            self.probs = Probs(probs)
        return self

    def verbose(self) -> str:
        """The log string: '2 persons, 1 bus, ', or '(no detections), ' (an
        oriented-box model's counted from its oriented boxes); a classify
        model's top 5 classes with their probabilities, 'cat 0.91, dog 0.05, '."""
        if self.probs is not None:
            return ", ".join(f"{self.names.get(i, i)} {self.probs.data[i]:.2f}" for i in self.probs.top5) + ", "
        src = self.obb if self.obb is not None else self.boxes
        if not len(src):
            return "(no detections), "
        cls = src.cls.astype(int)
        out = ""
        for c in np.unique(cls):
            n = int((cls == c).sum())
            out += f"{n} {self.names.get(int(c), str(int(c)))}{'s' * (n > 1)}, "
        return out

    def summary(self):
        """One dict per detection: name, class, confidence (5 decimals), box,
        track_id for tracked boxes, `segments` ({"x": [...], "y": [...]},
        Masks.xyn) where there is a mask for every box, and `keypoints`
        ({"x": [...], "y": [...]} in pixels, as the JAX package writes them,
        and "visible", the visibility scores, where nd is 3, as the
        reference writes them) where the detection has keypoints. An
        oriented-box model's rows give the enclosing axis-aligned boxes, as
        the JAX package's do (the reference's give the four corners). A
        classify model's one row: the top-1 class's name, class and
        confidence."""
        if self.probs is not None:
            i = self.probs.top1
            return [{"name": self.names.get(i, str(i)), "class": i, "confidence": round(self.probs.top1conf, 5)}]
        out = []
        b = self.boxes
        polys = self.masks.xyn if self.masks is not None and len(self.masks) == len(b) else None
        for i in range(len(b)):
            cls, conf = int(b.cls[i]), float(b.conf[i])
            x1, y1, x2, y2 = (float(v) for v in b.xyxy[i])
            row = {"name": self.names.get(cls, str(cls)), "class": cls, "confidence": round(conf, 5),
                   "box": {"x1": x1, "y1": y1, "x2": x2, "y2": y2}}
            if b.id is not None:
                row["track_id"] = int(b.id[i])
            if polys is not None:
                row["segments"] = {"x": polys[i][:, 0].tolist(), "y": polys[i][:, 1].tolist()}
            if self.keypoints is not None and i < len(self.keypoints):
                k = self.keypoints
                row["keypoints"] = {"x": k.xy[i][:, 0].tolist(), "y": k.xy[i][:, 1].tolist()}
                if k.conf is not None:
                    row["keypoints"]["visible"] = k.conf[i].tolist()
            out.append(row)
        return out

    def to_json(self):
        import json

        return json.dumps(self.summary(), indent=2)

    def tojson(self):
        """The older name of to_json."""
        return self.to_json()

    def to_sql(self, table_name: str = "results", db_path: str = "results.db"):
        """Append the detections to a sqlite table (class_name, confidence, the summary row as JSON)."""
        import json
        import sqlite3

        con = sqlite3.connect(db_path)
        try:
            cur = con.cursor()
            cur.execute(f'CREATE TABLE IF NOT EXISTS "{table_name}" '
                        "(id INTEGER PRIMARY KEY AUTOINCREMENT, class_name TEXT, confidence REAL, data TEXT)")
            for row in self.summary():
                cur.execute(f'INSERT INTO "{table_name}" (class_name, confidence, data) VALUES (?, ?, ?)',
                            (row["name"], row["confidence"], json.dumps(row)))
            con.commit()
        finally:
            con.close()
        return db_path

    def plot(self, line_width: Optional[int] = None):
        """An annotated copy of the original image (BGR): the masks blended
        in (each resized to the image by cv2.resize's default linear rule
        where it differs, kept where > 0, then 0.6 of the pixel plus 0.4 of
        its class colour, truncated, as the JAX package draws them), then
        each box and its 'name conf' label (with 'id:n' for tracked boxes),
        coloured by class, then every keypoint as a filled red dot of radius
        max(lw, 2), as the JAX package draws them. An oriented-box model's
        boxes are the enclosing axis-aligned ones, as the JAX package draws
        them (the reference draws the rotated polygons). A classify model's
        image carries its top 5 'name prob' lines in white, as the JAX
        package writes them."""
        import cv2

        img = self.orig_img.copy()
        lw = line_width or max(round(sum(img.shape[:2]) / 2 * 0.003), 2)
        if self.probs is not None:
            for j, i in enumerate(self.probs.top5):
                cv2.putText(img, f"{self.names.get(i, i)} {self.probs.data[i]:.2f}", (8, 28 + 24 * j),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2)
            return img
        b = self.boxes
        if self.masks is not None and len(self.masks):
            masks = np.asarray(self.masks)
            if masks.shape[1:] != img.shape[:2]:
                masks = np.stack([cv2.resize(m.astype(np.uint8), (img.shape[1], img.shape[0])) for m in masks]) > 0
            for i, m in enumerate(masks):
                color = _class_color(int(b.cls[i]) if i < len(b) else i)
                img[m] = (img[m] * 0.6 + np.array(color) * 0.4).astype(img.dtype)
        for i in range(len(b)):
            x1, y1, x2, y2 = (int(v) for v in b.xyxy[i])
            cls, conf = int(b.cls[i]), float(b.conf[i])
            color = _class_color(cls)
            cv2.rectangle(img, (x1, y1), (x2, y2), color, lw)
            label = f"{self.names.get(cls, cls)} {conf:.2f}"
            if b.id is not None:
                label = f"id:{int(b.id[i])} " + label
            cv2.putText(img, label, (x1, max(y1 - 3, 10)), cv2.FONT_HERSHEY_SIMPLEX, lw / 6, color, 1)
        if self.keypoints is not None:
            for k in self.keypoints.xy:
                for x, y in k:
                    cv2.circle(img, (int(x), int(y)), max(lw, 2), (0, 0, 255), -1)
        return img

    def show(self, *args, **kwargs):
        """Display the annotated image where a GUI is available; returns it."""
        img = self.plot()
        try:
            import cv2

            cv2.imshow(str(self.path), img)
            cv2.waitKey(1)
        except Exception:  # no GUI: the rendered array is the result
            pass
        return img

    def save(self, filename: str):
        import cv2

        cv2.imwrite(filename, self.plot())
        return filename

    def save_txt(self, txt_file: str, save_conf: bool = False):
        """YOLO label lines, 'cls x y w h' normalised (and conf with save_conf),
        '%.6g'; a segmentation model's too (no polygon); a pose model's
        followed by each keypoint's x and y normalised and its other columns;
        an oriented-box model's 'cls x1 y1 ... x4 y4' (its corners
        normalised, and conf), as the JAX package writes them."""
        lines = []
        h, w = self.orig_shape
        kpts = self.keypoints.data if self.keypoints is not None else None
        obb = self.obb if self.obb is not None and len(self.obb) else None
        for i in range(len(obb) if obb is not None else 0):
            pts = obb.xyxyxyxy[i].reshape(-1) / np.array([w, h] * 4, np.float32)
            vals = [int(obb.cls[i]), *pts.tolist()] + ([float(obb.conf[i])] if save_conf else [])
            lines.append(" ".join(f"{v:.6g}" if not isinstance(v, int) else str(v) for v in vals))
        for i in range(len(self.boxes) if obb is None else 0):
            cls, conf = int(self.boxes.cls[i]), float(self.boxes.conf[i])
            vals = [cls, *self.boxes.xywhn[i].tolist()] + ([conf] if save_conf else [])
            if kpts is not None:
                kn = kpts[i].copy()
                kn[..., 0] /= w
                kn[..., 1] /= h
                vals += kn.reshape(-1).tolist()
            lines.append(" ".join(f"{v:.6g}" if not isinstance(v, int) else str(v) for v in vals))
        p = Path(txt_file)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("\n".join(lines) + ("\n" if lines else ""))
        return str(p)

    def save_crop(self, save_dir: str, file_name: str = "crop"):
        """Each detection's crop as save_dir/<class name>/<file_name>_<i>.jpg."""
        import cv2

        saved = []
        for i in range(len(self.boxes)):
            (x1, y1, x2, y2), cls = self.boxes.xyxy[i], self.boxes.cls[i]
            x1, y1 = max(int(x1), 0), max(int(y1), 0)
            x2, y2 = min(int(x2), self.orig_shape[1]), min(int(y2), self.orig_shape[0])
            if x2 <= x1 or y2 <= y1:
                continue
            d = Path(save_dir) / self.names.get(int(cls), str(int(cls)))
            d.mkdir(parents=True, exist_ok=True)
            out = d / f"{file_name}_{i}.jpg"
            cv2.imwrite(str(out), self.orig_img[y1:y2, x1:x2])
            saved.append(str(out))
        return saved
