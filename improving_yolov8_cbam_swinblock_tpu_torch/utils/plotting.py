"""Drawing helpers: the port's copy of the detection and pose parts of the
JAX package's utils/plotting.py (Colors with the pose palette, the cv2
Annotator with its keypoints and the COCO skeleton, save_one_box,
feature_visualization, plot_images, plot_labels, plot_results,
output_to_target). cv2 is imported where an image is drawn and matplotlib
where a figure is, so the package imports without either; plot_images,
plot_labels and plot_results return None where theirs does not import."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

# the reference's class colour palette, (R, G, B)
_PALETTE = [
    (4, 42, 255), (11, 219, 235), (243, 243, 243), (0, 223, 183), (17, 31, 104),
    (255, 111, 221), (255, 68, 79), (204, 237, 0), (0, 243, 68), (189, 0, 255),
    (0, 180, 255), (221, 0, 186), (0, 192, 38), (255, 36, 125), (104, 0, 123),
    (108, 27, 255), (47, 109, 252), (104, 31, 17),
]


class Colors:
    """Indexable palette: colors(i) is class i's stable colour, (R, G, B) or
    (B, G, R) with bgr=True; `pose_palette` holds the keypoint and limb colours."""

    def __init__(self):
        self.palette = [p[::-1] for p in _PALETTE]
        self.n = len(self.palette)
        self.pose_palette = np.array(
            [(255, 128, 0), (255, 153, 51), (255, 178, 102), (230, 230, 0), (255, 153, 255), (153, 204, 255),
             (255, 102, 255), (255, 51, 255), (102, 178, 255), (51, 153, 255), (255, 153, 153), (255, 102, 102),
             (255, 51, 51), (153, 255, 153), (102, 255, 102), (51, 255, 51), (0, 255, 0), (0, 0, 255),
             (255, 0, 0), (255, 255, 255)], dtype=np.uint8)

    def __call__(self, i: int, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()

# the COCO-17 skeleton's limbs, pairs of 1-based keypoint indices
SKELETON = [[16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13], [6, 7], [6, 8], [7, 9], [8, 10],
            [9, 11], [2, 3], [1, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]]


def color_for(idx: int):
    return _PALETTE[int(idx) % len(_PALETTE)]


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST) for size (h,
    w): destination pixel (y, x) takes source (min(floor(y * sh / h), sh - 1),
    min(floor(x * sw / w), sw - 1)), the scales taken in doubles as
    1 / (h / sh), as OpenCV's resizeNN takes them."""
    sh, sw = img.shape[:2]
    h, w = size
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
    return img[ys[:, None], xs[None, :]]


class Annotator:
    """Boxes, text, masks and keypoints drawn in place on a copy of a BGR image (`.img`, also `.im`)."""

    def __init__(self, img: np.ndarray, line_width: Optional[int] = None, names: Optional[Dict] = None, **_):
        self.img = np.ascontiguousarray(img)
        self.lw = line_width or max(round(sum(img.shape[:2]) / 2 * 0.003), 2)
        self.tf = max(self.lw - 1, 1)  # font thickness
        self.sf = self.lw / 3  # font scale
        self.names = names or {}
        self.skeleton = SKELETON
        self.limb_color = colors.pose_palette[[9, 9, 9, 9, 7, 7, 7, 0, 0, 0, 0, 0, 16, 16, 16, 16, 16, 16, 16]]
        self.kpt_color = colors.pose_palette[[16, 16, 16, 16, 16, 0, 0, 0, 0, 0, 0, 9, 9, 9, 9, 9, 9]]

    @property
    def im(self):
        return self.img

    @staticmethod
    def get_txt_color(color=(128, 128, 128), txt_color=(255, 255, 255)):
        """Black text on light boxes (luma over 160), else txt_color."""
        luma = 0.299 * color[2] + 0.587 * color[1] + 0.114 * color[0]
        return (0, 0, 0) if luma > 160 else txt_color

    def box_label(self, box: Sequence[float], label: str = "", color=(128, 128, 128), txt_color=(255, 255, 255)):
        """An xyxy box and its label on a filled strip above it (below it at the top edge)."""
        import cv2

        txt_color = self.get_txt_color(color, txt_color)
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        cv2.rectangle(self.img, p1, p2, color, self.lw, cv2.LINE_AA)
        if label:
            w, h = cv2.getTextSize(label, 0, self.sf, self.tf)[0]
            outside = p1[1] - h >= 3
            p2t = (p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3)
            cv2.rectangle(self.img, p1, p2t, color, -1, cv2.LINE_AA)
            cv2.putText(self.img, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2),
                        0, self.sf, txt_color, self.tf, cv2.LINE_AA)

    def text(self, xy: Sequence[float], text: str, txt_color=(255, 255, 255), box_style: bool = False):
        """Text at xy, optionally on a filled box."""
        import cv2

        w, h = cv2.getTextSize(text, 0, self.sf, self.tf)[0]
        org = (int(xy[0]), int(xy[1]) + h)
        if box_style:
            cv2.rectangle(self.img, (org[0] - 2, org[1] - h - 3), (org[0] + w + 2, org[1] + 3), txt_color, -1)
            txt_color = self.get_txt_color(txt_color)
        cv2.putText(self.img, text, org, 0, self.sf, txt_color, self.tf, cv2.LINE_AA)

    def masks(self, masks: np.ndarray, colors_: Sequence, alpha: float = 0.5):
        """Blend instance masks (n, h, w) (bool or 0/1, at any resolution) in
        place: each resized to the image by nearest neighbour (resize_nearest,
        cv2.INTER_NEAREST's rule), then where it is nonzero the pixel becomes
        pixel * (1 - alpha) + colour * alpha in float32, truncated, as the JAX
        package's Annotator.masks does."""
        h, w = self.img.shape[:2]
        for m, c in zip(np.asarray(masks), colors_):
            if m.shape != (h, w):
                m = resize_nearest(m.astype(np.uint8), (h, w))
            sel = m.astype(bool)
            self.img[sel] = (self.img[sel] * (1 - alpha) + np.array(c, np.float32) * alpha).astype(self.img.dtype)

    def kpts(self, kpts: np.ndarray, shape=None, radius: Optional[int] = None, kpt_line: bool = True,
             conf_thres: float = 0.25):
        """One instance's keypoints (nk, 2 or 3) in pixels, in place: each
        point whose visibility (1 where nd is 2) reaches conf_thres a filled
        circle of radius max(lw, 2) (anti-aliased), in kpt_color where nk is
        17, else the class palette's colour of its index; with kpt_line and
        17 points, the COCO skeleton's limbs between points that both reach
        conf_thres, lw // 2 wide (at least 1). The JAX package's Annotator.kpts."""
        import cv2

        kpts = np.asarray(kpts, np.float32)
        radius = radius or max(self.lw, 2)
        nk = len(kpts)
        is_pose = nk == 17
        conf = kpts[:, 2] if kpts.shape[-1] == 3 else np.ones(nk, np.float32)
        for i, (pt, cf) in enumerate(zip(kpts, conf)):
            if cf < conf_thres:
                continue
            c = tuple(int(v) for v in self.kpt_color[i]) if is_pose else colors(i)
            cv2.circle(self.img, (int(pt[0]), int(pt[1])), radius, c, -1, cv2.LINE_AA)
        if kpt_line and is_pose:
            for j, (a, b) in enumerate(self.skeleton):
                if conf[a - 1] < conf_thres or conf[b - 1] < conf_thres:
                    continue
                p1 = (int(kpts[a - 1, 0]), int(kpts[a - 1, 1]))
                p2 = (int(kpts[b - 1, 0]), int(kpts[b - 1, 1]))
                cv2.line(self.img, p1, p2, tuple(int(v) for v in self.limb_color[j]), max(self.lw // 2, 1),
                         cv2.LINE_AA)

    def result(self) -> np.ndarray:
        return self.img

    def save(self, filename: str = "image.jpg"):
        import cv2

        cv2.imwrite(filename, self.img)
        return filename


def save_one_box(xyxy, im: np.ndarray, file: Optional[str] = None, gain: float = 1.02, pad: int = 10,
                 square: bool = False, save: bool = True):
    """The crop of a box grown by gain and pad (squared with `square`),
    clipped to the image; written to `file` with `save`."""
    b = np.asarray(xyxy, np.float32).reshape(-1, 4)[0]
    cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
    w, h = (b[2] - b[0]) * gain + pad, (b[3] - b[1]) * gain + pad
    if square:
        w = h = max(w, h)
    x1, y1 = int(max(cx - w / 2, 0)), int(max(cy - h / 2, 0))
    x2, y2 = int(min(cx + w / 2, im.shape[1])), int(min(cy + h / 2, im.shape[0]))
    crop = im[y1:y2, x1:x2]
    if save and file is not None:
        import cv2

        Path(file).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(file), crop)
    return crop


def feature_visualization(features, module_name: str, save_dir: str = ".", n: int = 32) -> Optional[str]:
    """The feature-map grid of one layer's output, as the JAX package's
    feature_visualization draws it: `features` is (B, C, H, W) (a tensor or
    an array); the first image's first n channels, each min-max normalised
    in float32, tiled row by row on a ceil(sqrt(n)) square grid and written
    as <save_dir>/<module_name>_features.png (grey, 8 bit). Returns the
    path, or None for an output that is not rank 4."""
    import cv2

    if features.ndim != 4:
        return None
    f = features[0, :n]
    f = f.detach().float().cpu().numpy() if hasattr(f, "detach") else np.asarray(f)
    c = f.shape[0]
    ns = int(np.ceil(c**0.5))
    h, w = f.shape[1:]
    grid = np.zeros((ns * h, ns * w), np.float32)
    for i in range(c):
        ch = f[i].astype(np.float32)
        lo, hi = float(ch.min()), float(ch.max())
        ch = (ch - lo) / (hi - lo + 1e-9)
        r, col = divmod(i, ns)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = ch
    out = str(Path(save_dir) / f"{module_name}_features.png")
    cv2.imwrite(out, (grid * 255).astype(np.uint8))
    return out


def plot_images(images: np.ndarray, cls: np.ndarray, bboxes: np.ndarray, mask: np.ndarray,
                fname: str = "train_batch.jpg", names: Optional[Dict] = None, max_images: int = 16) -> Optional[str]:
    """A batch as a grid of its images with their boxes (JAX utils/plotting.py:215):
    images (B, H, W, 3) uint8 RGB, cls (B, G), bboxes (B, G, 4) normalised
    xywh, mask (B, G). None without cv2."""
    try:
        import cv2
    except ImportError:
        return None
    b = min(len(images), max_images)
    ns = int(np.ceil(b**0.5))
    h, w = images.shape[1:3]
    grid = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(b):
        r, c = divmod(i, ns)
        ann = Annotator(images[i][..., ::-1].copy(), names=names)  # RGB -> BGR for cv2
        for j in range(bboxes.shape[1]):
            if mask[i, j] > 0:
                cx, cy, bw, bh = bboxes[i, j]
                box = [(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h]
                k = int(cls[i, j])
                ann.box_label(box, (names or {}).get(k, str(k)), color_for(k))
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = ann.result()
    cv2.imwrite(fname, grid)
    return fname


def plot_labels(cls: np.ndarray, boxes: np.ndarray, names: Optional[Dict] = None, save_dir: str = ".") -> Optional[str]:
    """labels.jpg, the dataset's label statistics (JAX utils/plotting.py:244):
    instances per class, box centres, box sizes. cls (N,), boxes (N, 4)
    normalised xywh of every instance. None without matplotlib."""
    from .metrics import _pyplot

    plt = _pyplot()
    if plt is None:
        return None
    cls = np.asarray(cls).astype(int).reshape(-1)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    fig, axes = plt.subplots(2, 2, figsize=(10, 8))
    nc = int(cls.max()) + 1 if len(cls) else 1
    axes[0, 0].hist(cls, bins=np.arange(nc + 1) - 0.5, rwidth=0.8)
    axes[0, 0].set_title("instances per class")
    if names:
        axes[0, 0].set_xticks(range(nc))
        axes[0, 0].set_xticklabels([str(names.get(i, i)) for i in range(nc)], rotation=90, fontsize=7)
    axes[0, 1].hist2d(boxes[:, 0], 1 - boxes[:, 1], bins=50, range=[[0, 1], [0, 1]], cmap="Blues")
    axes[0, 1].set_title("box centers (x, y)")
    axes[1, 0].hist2d(boxes[:, 2], boxes[:, 3], bins=50, range=[[0, 1], [0, 1]], cmap="Blues")
    axes[1, 0].set_title("box sizes (w, h)")
    axes[1, 1].scatter(boxes[:, 2], boxes[:, 3], s=2, alpha=0.3)
    axes[1, 1].set_title("w vs h")
    fig.tight_layout()
    out = str(Path(save_dir) / "labels.jpg")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def plot_results(csv_path: str, out: Optional[str] = None) -> Optional[str]:
    """results.png, a curve per column of results.csv (JAX utils/plotting.py:304). None without matplotlib."""
    import csv

    from .metrics import _pyplot

    plt = _pyplot()
    if plt is None:
        return None
    with open(csv_path) as fh:
        rows = list(csv.DictReader(fh))
    if not rows:
        return None
    keys = [k for k in rows[0] if k not in ("epoch", "time_s")]
    epochs = [int(float(r["epoch"])) for r in rows]
    ncols = min(4, len(keys))
    nrows = int(np.ceil(len(keys) / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        ax.plot(epochs, [float(r[k]) if r[k] else float("nan") for r in rows], marker=".")
        ax.set_title(k, fontsize=9)
    fig.tight_layout()
    out = out or str(Path(csv_path).with_name("results.png"))
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def output_to_target(output, max_det: int = 300):
    """NMS output (B, n, 6) xyxy, conf, cls -> (batch index, class, xywh, conf)
    arrays of the kept detections (JAX utils/plotting.py:390)."""
    bids, clss, boxes, confs = [], [], [], []
    for i, o in enumerate(np.asarray(output)):
        o = o[:max_det]
        o = o[o[:, 4] > 0]
        xyxy = o[:, :4]
        bids.append(np.full(len(o), i))
        clss.append(o[:, 5])
        boxes.append(np.concatenate([(xyxy[:, :2] + xyxy[:, 2:4]) / 2, xyxy[:, 2:4] - xyxy[:, :2]], 1))
        confs.append(o[:, 4])
    if not bids:
        return np.zeros(0), np.zeros(0), np.zeros((0, 4)), np.zeros(0)
    return np.concatenate(bids), np.concatenate(clss), np.concatenate(boxes), np.concatenate(confs)
