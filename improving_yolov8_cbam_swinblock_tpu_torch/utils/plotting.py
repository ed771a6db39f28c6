"""Drawing helpers of the predict path: the port's copy of the detection
part of the JAX package's utils/plotting.py (Colors, the cv2 Annotator,
save_one_box, feature_visualization). Drawing needs cv2, imported where it
draws, so the package imports without it."""

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
    (B, G, R) with bgr=True."""

    def __init__(self):
        self.palette = [p[::-1] for p in _PALETTE]
        self.n = len(self.palette)

    def __call__(self, i: int, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()


class Annotator:
    """Boxes and text drawn in place on a copy of a BGR image (`.img`, also `.im`)."""

    def __init__(self, img: np.ndarray, line_width: Optional[int] = None, names: Optional[Dict] = None, **_):
        self.img = np.ascontiguousarray(img)
        self.lw = line_width or max(round(sum(img.shape[:2]) / 2 * 0.003), 2)
        self.tf = max(self.lw - 1, 1)  # font thickness
        self.sf = self.lw / 3  # font scale
        self.names = names or {}

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
