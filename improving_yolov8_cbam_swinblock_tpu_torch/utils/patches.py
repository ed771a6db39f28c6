"""Image decode for the data path (counterpart of the JAX package's utils/patches.py:imread).

`imread` returns a BGR uint8 (H, W, 3) image, or None where the file is
missing, empty or undecodable, as cv2.imread does. It decodes with cv2
where cv2 imports, else with PIL where PIL imports, else with the port's own
PNG decoder (numpy and the stdlib's zlib). A JPEG (or any other format that
is not PNG) with neither cv2 nor PIL raises, naming the file.

`image_size` reads (w, h) and the format from the PNG, JPEG and BMP headers
without decoding the pixels; the dataset verifies images and computes its
rect shape with it.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# JPEG start-of-frame markers (baseline, progressive, lossless, arithmetic):
# C0-CF without DHT (C4), JPG (C8) and DAC (CC)
_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


@functools.cache
def _decoder() -> str:
    """'cv2', 'pil' or 'png': the first decoder that imports, in that order,
    worked out once per process."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    try:
        from PIL import Image  # noqa: F401

        return "pil"
    except ImportError:
        return "png"


def imread(filename, decoder: Optional[str] = None) -> Optional[np.ndarray]:
    """BGR uint8 (H, W, 3), or None for a missing, empty or undecodable file.
    `decoder` forces 'cv2', 'pil' or 'png' (default: the first that imports)."""
    try:
        buf = Path(filename).read_bytes()
    except OSError:
        return None
    if not buf:
        return None
    decoder = decoder or _decoder()
    if decoder == "cv2":
        import cv2

        return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    if decoder == "pil":
        import io

        from PIL import Image

        try:
            with Image.open(io.BytesIO(buf)) as im:
                rgb = np.asarray(im.convert("RGB"))
        except (OSError, ValueError):
            return None
        return np.ascontiguousarray(rgb[..., ::-1])
    if not buf.startswith(PNG_SIGNATURE):
        raise RuntimeError(f"cannot decode {filename}: neither cv2 nor PIL imports, and the port's own "
                           "decoder reads PNG only")
    try:
        return decode_png(buf)
    except (ValueError, zlib.error, struct.error) as e:
        raise RuntimeError(f"cannot decode {filename}: {e}") from e


def _chunks(buf: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        yield kind, buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters: (h, stride) uint8. None, Sub and Up are
    vectorised; Average and Paeth loop over the row's bytes."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum mod 256 along each byte lane
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:  # Average
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:  # Paeth
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype} is not one of the five")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """A non-interlaced PNG of gray, gray + alpha, RGB, RGBA or palette
    pixels (8-bit; gray and palette also 1, 2 and 4 bits) as BGR uint8
    (H, W, 3), as cv2.imdecode(IMREAD_COLOR) gives it: alpha dropped, gray
    repeated, low gray depths scaled to 0..255."""
    if not buf.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    ihdr, palette, idat = None, None, []
    for kind, data in _chunks(buf):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise ValueError(f"PNG color type {ctype} is not a PNG color type")
    if interlace:
        raise ValueError("interlaced PNG is not read by the port's decoder")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{depth}-bit PNG of color type {ctype} is not read by the port's decoder")
    stride = (w * channels * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, channels * depth // 8))
    if depth < 8:
        vals = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        px = (vals * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1).astype(np.uint8)
        if ctype == 0:
            px = (px.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        px = px[..., None]
    else:
        px = rows.reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        rgb = palette[np.minimum(px[..., 0], len(palette) - 1)]
    elif ctype in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=-1)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _tiff_size(fh, head: bytes, path) -> Tuple[int, int, str]:
    """Tags 256 (width) and 257 (height) of a TIFF's first image file directory."""
    end = "<" if head[:2] == b"II" else ">"
    fh.seek(struct.unpack(end + "I", head[4:8])[0])
    (n,) = struct.unpack(end + "H", fh.read(2))
    size = {}
    for _ in range(n):
        entry = fh.read(12)
        if len(entry) < 12:
            break
        tag, kind = struct.unpack(end + "HH", entry[:4])
        if tag in (256, 257):
            size[tag] = struct.unpack(end + ("H" if kind == 3 else "I"), entry[8:10] if kind == 3 else entry[8:12])[0]
    if len(size) < 2:
        raise ValueError(f"TIFF without a width and a height: {path}")
    return int(size[256]), int(size[257]), "tiff"


def _webp_size(head: bytes, path) -> Tuple[int, int, str]:
    """The canvas of a WebP's first chunk: VP8 (lossy), VP8L (lossless) or VP8X (extended)."""
    kind = head[12:16]
    if kind == b"VP8 " and head[23:26] == b"\x9d\x01\x2a":
        w, h = struct.unpack("<HH", head[26:30])
        return w & 0x3FFF, h & 0x3FFF, "webp"
    if kind == b"VP8L" and head[20] == 0x2F:
        (b,) = struct.unpack("<I", head[21:25])
        return (b & 0x3FFF) + 1, ((b >> 14) & 0x3FFF) + 1, "webp"
    if kind == b"VP8X":
        return int.from_bytes(head[24:27], "little") + 1, int.from_bytes(head[27:30], "little") + 1, "webp"
    raise ValueError(f"WebP without a VP8, VP8L or VP8X header: {path}")


def image_size(path) -> Tuple[int, int, str]:
    """(w, h, format) from the header of a PNG, JPEG, BMP, TIFF or WebP file,
    without decoding it; format is 'png', 'jpeg', 'bmp', 'tiff' or 'webp'.
    Raises ValueError for another format or a header that does not parse."""
    with open(path, "rb") as fh:
        head = fh.read(32)
        if head[:4] in (b"II*\x00", b"MM\x00*"):
            return _tiff_size(fh, head, path)
        if head[:4] == b"RIFF" and head[8:12] == b"WEBP" and len(head) >= 30:
            return _webp_size(head, path)
        if head.startswith(PNG_SIGNATURE):
            if head[12:16] != b"IHDR":
                raise ValueError(f"PNG without IHDR: {path}")
            w, h = struct.unpack(">II", head[16:24])
            return int(w), int(h), "png"
        if head.startswith(b"BM") and len(head) >= 26:
            w, h = struct.unpack("<ii", head[18:26])
            return int(w), abs(int(h)), "bmp"
        if head.startswith(b"\xff\xd8"):
            fh.seek(2)
            while True:
                b = fh.read(1)
                while b and b != b"\xff":  # skip to the next marker
                    b = fh.read(1)
                while b == b"\xff":
                    b = fh.read(1)
                if not b:
                    break
                marker = b[0]
                if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:  # markers without a length
                    continue
                seg = fh.read(2)
                if len(seg) < 2:
                    break
                n = struct.unpack(">H", seg)[0]
                if marker in _SOF:
                    body = fh.read(5)
                    if len(body) < 5:
                        break
                    h, w = struct.unpack(">HH", body[1:5])
                    return int(w), int(h), "jpeg"
                fh.seek(n - 2, 1)
            raise ValueError(f"JPEG without a frame header: {path}")
    raise ValueError(f"not a PNG, JPEG, BMP, TIFF or WebP file: {path}")


# ---------------------------------------------------------------------------
# fill_poly: cv2.fillPoly(img, [pts], color) (lineType LINE_8, shift 0) of the OpenCV 5 build
# the JAX package runs with, in numpy, bit for bit, for the segment targets. cv2 draws each
# edge's 8-connected line (its LineIterator, the line clipped to the image first), then fills
# each scanline between the sorted 16.16 fixed-point x's of the edges that cross it, the pixels
# from ceil(x) of one edge to floor(x) of the next (CollectPolyEdges and FillEdgeCollection of
# OpenCV's drawing.cpp; rules found against cv2.fillPoly itself, tests/test_torch_segment.py).

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, p1, p2):
    """cv2.clipLine on an image of w x h: (inside, p1, p2), the points moved
    onto the image's edges as cv2 moves them (in doubles, truncated), also
    where it returns False."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, (x1, y1), (x2, y2)
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(w: int, h: int, p1, p2) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) of the pixels cv2.line(LINE_8) sets from p1 to p2 on a w x h
    image: the line clipped to the image, then Bresenham from its left end,
    the secondary axis stepping where the error term is negative."""
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        inside, p1, p2 = clip_line(w, h, p1, p2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:  # left to right
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # minor steps before pixel k: the j < k whose error dx - 2dy - 2dy j + 2dx m_j is negative
    m = (2 * minor * k + major - 1) // (2 * major) if major else np.zeros_like(k)
    if vert:
        return x1 + m, y1 + sy * k
    return x1 + k, y1 + sy * m


def fill_poly(img: np.ndarray, pts, color) -> np.ndarray:
    """cv2.fillPoly(img, [pts], color) in place for one polygon of integer
    vertices (n, 2) on a single-channel image: returns img."""
    h, w = img.shape[:2]
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    edges = []  # (y0, y1, x at y0 in 16.16, dx per row in 16.16)
    n = len(pts)
    for i in range(n):
        (x0, y0), (x1, y1) = (int(v) for v in pts[i - 1]), (int(v) for v in pts[i])
        xs, ys = line_pixels(w, h, (x0, y0), (x1, y1))
        img[ys, xs] = color
        c0y, c1y = y0, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            # an edge that leaves the image runs through its clipped endpoints' x, and their y
            # unless the clip made it horizontal (then through the vertices' y)
            _, (x0, t0y), (x1, t1y) = clip_line(w, h, (x0, y0), (x1, y1))
            if t0y != t1y:
                c0y, c1y = t0y, t1y
        c0x, c1x = x0 << XY_SHIFT, x1 << XY_SHIFT
        if y0 == y1:
            continue
        dx = _tdiv(c1x - c0x, c1y - c0y)
        if y0 < y1:
            edges.append((y0, y1, c0x + (y0 - c0y) * dx, dx))
        else:
            edges.append((y1, y0, c1x + (y1 - c1y) * dx, dx))
    if len(edges) < 2:
        return img
    e = np.array(edges, np.int64)
    ey0, ey1, ex, edx = e.T
    xend = ex + (ey1 - ey0) * edx
    if ey1.max() < 0 or ey0.min() >= h or max(ex.max(), xend.max()) < 0 or min(ex.min(), xend.min()) >= (w << XY_SHIFT):
        return img
    # each row y in [0, min(max y1, h)) pairs the sorted x's of the edges with y0 <= y < y1 (an even count)
    y = np.arange(max(int(ey0.min()), 0), min(int(ey1.max()), h), dtype=np.int64)[:, None]
    active = (ey0 <= y) & (y < ey1)
    big = np.iinfo(np.int64).max
    xs = np.sort(np.where(active, ex + (y - ey0) * edx, big), axis=1)
    if xs.shape[1] % 2:
        xs = np.concatenate([xs, np.full((len(xs), 1), big)], 1)
    xa, xb = xs[:, 0::2], xs[:, 1::2]
    valid = xb != big
    x1 = (np.where(valid, xa, 0) + XY_ONE - 1) >> XY_SHIFT  # the pixels whose x lies in [xa, xb]
    x2 = np.where(valid, xb, 0) >> XY_SHIFT
    draw = valid & (x1 < w) & (x2 >= 0)
    rows = np.broadcast_to(y, x1.shape)[draw]
    x1, x2 = np.clip(x1[draw], 0, None), np.clip(x2[draw], None, w - 1)
    span = np.zeros((h, w + 1), np.int32)
    np.add.at(span, (rows, x1), 1)
    np.add.at(span, (rows, x2 + 1), -1)
    img[np.cumsum(span, 1)[:, :w] > 0] = color
    return img


# ---------------------------------------------------------------------------
# find_contours: cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) of the OpenCV 5 build,
# in numpy, bit for bit: Suzuki and Abe's border following on the mask padded by one zero pixel.
# A raster scan meets each border start (a nonzero pixel whose left neighbour is 0, not yet
# marked) and follows the outer border from it unless the last marked pixel before it on its
# row (LNBD) is marked positive, i.e. the start lies inside a component already followed; the
# following marks each border pixel 2, or 3 where it searched its right neighbour and found 0
# (OpenCV's nbd and nbd | -128). Directions are OpenCV's chain codes (0 right, then
# counter-clockwise on the screen: 2 up, 4 left, 6 down). CHAIN_APPROX_SIMPLE keeps the pixels
# where the direction changes. cv2 lists the contours last found first. Rules held against
# cv2.findContours itself (tests/test_torch_masks.py).

_CHAIN = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))  # (dx, dy) of each code


def _follow_tables():
    """START[code]: the first direction searched clockwise from 3 (down to 5)
    that holds a nonzero neighbour, or 8 for an isolated pixel; NEXT[code * 8
    + back]: the next direction searched counter-clockwise after `back` (the
    direction to the pixel it came from), plus 8 where the search passed the
    right neighbour (direction 0) and found it 0. `code` has bit k set where
    the neighbour in direction k is nonzero."""
    start, nxt = bytearray(256), bytearray(256 * 8)
    for code in range(256):
        start[code] = next((s for s in (3, 2, 1, 0, 7, 6, 5) if code >> s & 1), 8)
        for back in range(8):
            raw = next((s for s in range(back + 1, back + 9) if code >> (s & 7) & 1), back + 8)
            nxt[code * 8 + back] = (raw & 7) | (8 if raw > 8 else 0)
    return bytes(start), bytes(nxt)


_START, _NEXT = _follow_tables()


def _follow(buf: bytearray, codes: bytes, step: int, p0: int) -> Tuple[list, list]:
    """Follow the outer border from the flat index p0 of the padded image
    (row stride `step`), marking buf: (flat indices of the pixels kept by
    CHAIN_APPROX_SIMPLE, flat indices marked)."""
    d = [dx + dy * step for dx, dy in _CHAIN]
    s = _START[codes[p0]]
    if s == 8:  # a single pixel
        buf[p0] = 3
        return [p0], [p0]
    p1 = p0 + d[s]  # the last pixel of the border, before p0
    prev_s, back, p, pts, marked = s ^ 4, s, p0, [], []
    while True:
        v = _NEXT[codes[p] * 8 + back]
        s = v & 7
        if v & 8:
            buf[p] = 3
            marked.append(p)
        elif buf[p] == 1:
            buf[p] = 2
            marked.append(p)
        if s != prev_s:
            pts.append(p)
            prev_s = s
        q = p + d[s]
        if q == p0 and p == p1:
            return pts, marked
        p, back = q, (s + 4) & 7


def find_contours(mask: np.ndarray) -> list:
    """cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
    as a list of (k, 2) int32 (x, y) arrays: the outer border of each
    8-connected component of the nonzero pixels of a 2-D mask that lies
    in no hole of another, each from its first pixel in raster order, in
    cv2's direction and order. The start points come from a vectorised scan
    over the mask's bounding box; only the border walk loops in Python."""
    m = np.asarray(mask) != 0
    if m.ndim != 2 or not m.any():
        return []
    rows, cols = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
    y0, x0 = int(rows[0]), int(cols[0])
    sub = m[y0:rows[-1] + 1, x0:cols[-1] + 1]
    h, w = sub.shape
    step = w + 2
    pad = np.zeros((h + 2, step), np.uint8)
    pad[1:-1, 1:-1] = sub
    code = np.zeros_like(pad)
    for k, (dx, dy) in enumerate(_CHAIN):  # bit k: the neighbour in direction k is nonzero
        code[1:-1, 1:-1] |= pad[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx] << k
    buf = bytearray(pad.tobytes())
    flat = np.frombuffer(buf, np.uint8)  # a view: the walk's marks show in it
    codes = code.tobytes()
    starts = np.flatnonzero((flat[1:] == 1) & (flat[:-1] == 0)) + 1  # raster order
    marks = np.zeros(0, np.int64)
    found, at = [], 0
    while at < len(starts):
        cand = starts[at:]
        cand = cand[flat[cand] == 1]  # not marked by a border followed since
        if not len(cand):
            break
        j = np.searchsorted(marks, cand) - 1  # LNBD: the last marked pixel before each, on its row
        last = marks[np.maximum(j, 0)] if len(marks) else cand
        inside = (j >= 0) & (last // step == cand // step) & (flat[last] == 2)
        k = int(np.argmin(inside))
        if inside[k]:
            break
        pts, marked = _follow(buf, codes, step, int(cand[k]))
        marks = np.union1d(marks, marked)
        at = int(np.searchsorted(starts, cand[k])) + 1
        idx = np.asarray(pts, np.int64)
        found.append(np.stack([idx % step - 1 + x0, idx // step - 1 + y0], 1).astype(np.int32))
    return found[::-1]


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea(contour): the shoelace area of the closed polygon,
    unsigned; 0 for no point. The vertices are taken as float32 and the
    terms summed in float64 in cv2's order (a running sum from the edge that
    closes the polygon), so float polygons give cv2's bits too."""
    c = np.asarray(contour, np.float32).reshape(-1, 2).astype(np.float64)
    if not len(c):
        return 0.0
    prev = np.roll(c, 1, 0)
    return float(abs(np.cumsum(prev[:, 0] * c[:, 1] - prev[:, 1] * c[:, 0])[-1] * 0.5))


# ---------------------------------------------------------------------------
# min_area_rect: cv2.minAreaRect of the OpenCV 5 build the JAX package runs with, in numpy, for
# the OBB targets. The points' convex hull (cv2.convexHull's counter-clockwise output: its
# Sklansky scans of the x-sorted points, then the cyclic shift that makes the indices ascend),
# then rotating calipers in float32 (OpenCV's rotcalipers.cpp: four calipers from the lowest,
# rightmost, highest and leftmost points, each step turning the caliper of the smallest angle
# onto its edge, the last rectangle of the least area kept), the box's angle in degrees brought
# into [-90, 0) by steps of 90 with the sides swapped at each step. Rules found against
# cv2.minAreaRect itself (tests/test_torch_obb_train.py).

_F32_MAX = float(np.finfo(np.float32).max)


def _f(v) -> float:
    """v rounded to float32, as a Python float."""
    return float(np.float32(v))


def _sign(v) -> int:
    return (v > 0) - (v < 0)


def _sklansky(p, start: int, end: int, nsign: int, sign2: int) -> list:
    """One Sklansky scan of cv2's convexHull over the x-sorted points p from
    start towards end: the stack of kept indices."""
    incr = 1 if end > start else -1
    if start == end or p[start] == p[end]:
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext] + [0] * (abs(end - start) + 2)
    size = 3
    end += incr
    while pnext != end:
        cury, nexty = p[pcur][1], p[pnext][1]
        by = _f(nexty - cury)
        if _sign(by) != nsign:
            ax, bx = _f(p[pcur][0] - p[pprev][0]), _f(p[pnext][0] - p[pcur][0])
            ay = _f(cury - p[pprev][1])
            if _sign(ay * bx - ax * by) == sign2 and (ax != 0 or ay != 0):  # a convex turn (in float64)
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[size - 2] = pnext
                pcur = pprev
                pprev = stack[size - 4]
                size -= 1
        else:
            pnext += incr
            stack[size - 1] = pnext
    return stack[:size - 1]


def convex_hull(points) -> np.ndarray:
    """cv2.convexHull(points) (counter-clockwise, the points returned) of
    float32 points (n, 2): (m, 2) float32, in cv2's order."""
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    total = len(pts)
    if total == 0:
        return pts
    order = sorted(range(total), key=lambda i: (pts[i, 0], pts[i, 1]))
    p = [(float(pts[i, 0]), float(pts[i, 1])) for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if p[miny][1] > p[i][1]:
            miny = i
        if p[maxy][1] < p[i][1]:
            maxy = i
    if p[0] == p[total - 1]:
        return pts[[order[0]]]
    tl, tr = _sklansky(p, total - 1, maxy, -1, -1), _sklansky(p, 0, maxy, -1, 1)  # the upper half
    hull = [order[i] for i in tl[:-1]] + [order[tr[i]] for i in range(len(tr) - 1, 0, -1)]
    stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
    bl, br = _sklansky(p, 0, miny, 1, -1), _sklansky(p, total - 1, miny, 1, 1)  # the lower half
    nbl, nbr = len(bl), len(br)
    if stop >= 0:
        check = bl[1] if nbl > 2 else br[2 - nbl] if nbl + nbr > 2 else -1
        if check == stop or (check >= 0 and p[check] == p[stop]):  # collinear: the lower half mirrors the upper
            nbl, nbr = min(nbl, 2), min(nbr, 2)
    hull += [order[i] for i in bl[:nbl - 1]] + [order[br[i]] for i in range(nbr - 1, 0, -1)]
    n = len(hull)
    if n >= 3:  # a cyclic shift that makes the indices ascend (or descend), where one does
        lo = hi = lt = 0
        for i in range(1, n):
            lt += hull[i - 1] < hull[i]
            if 1 < lt <= i - 2:
                break
            lo = i if hull[i] < hull[lo] else lo
            hi = i if hull[i] > hull[hi] else hi
        if abs(hi - lo) in (1, n - 1) and (lt <= 1 or lt >= n - 2):
            ascending = (hi + 1) % n == lo
            i0 = lo if ascending else hi
            shifted = hull[i0:] + hull[:i0]
            if i0 > 0 and all(ascending == (a < b) for a, b in zip(shifted, shifted[1:])):
                hull = shifted
    return pts[hull]


def _calipers(P: list):
    """OpenCV's rotatingCalipers (CALIPERS_MINAREARECT) in float32 over the
    hull P: (corner, side along the base, side across it) of the rectangle."""
    n = len(P)
    vect, inv = [], []
    left = bottom = right = top = 0
    left_x = right_x = P[0][0]
    top_y = bottom_y = P[0][1]
    for i in range(n):
        x0, y0 = P[i]
        if x0 < left_x:
            left_x, left = x0, i
        if x0 > right_x:
            right_x, right = x0, i
        if y0 > top_y:
            top_y, top = y0, i
        if y0 < bottom_y:
            bottom_y, bottom = y0, i
        dx, dy = P[(i + 1) % n][0] - x0, P[(i + 1) % n][1] - y0  # exact in float64
        vect.append((_f(dx), _f(dy)))
        inv.append(_f(1.0 / math.sqrt(dx * dx + dy * dy)))
    orientation = 0.0
    ax, ay = vect[-1]
    for bx, by in vect:
        c = ax * by - ay * bx
        if c != 0:
            orientation = 1.0 if c > 0 else -1.0
            break
        ax, ay = bx, by
    a, b = orientation, 0.0
    seq = [bottom, right, top, left]
    minarea, best = _F32_MAX, None
    for _ in range(n):
        v = [vect[s] for s in seq]
        dp = (_f(_f(a * v[0][0]) + _f(b * v[0][1])), _f(_f(-b * v[1][0]) + _f(a * v[1][1])),
              _f(_f(-a * v[2][0]) - _f(b * v[2][1])), _f(_f(b * v[3][0]) - _f(a * v[3][1])))
        main, maxcos = 0, _f(dp[0] * inv[seq[0]])
        for i in range(1, 4):
            c = _f(dp[i] * inv[seq[i]])
            if c > maxcos:
                main, maxcos = i, c
        k = seq[main]
        lx, ly = _f(vect[k][0] * inv[k]), _f(vect[k][1] * inv[k])
        a, b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = (seq[main] + 1) % n
        dx, dy = _f(P[seq[1]][0] - P[seq[3]][0]), _f(P[seq[1]][1] - P[seq[3]][1])
        width = _f(_f(dx * a) + _f(dy * b))
        dx, dy = _f(P[seq[2]][0] - P[seq[0]][0]), _f(P[seq[2]][1] - P[seq[0]][1])
        height = _f(_f(-dx * b) + _f(dy * a))
        area = _f(width * height)
        if area <= minarea:
            minarea, best = area, (seq[3], a, width, b, height, seq[0])
    il, a1, width, b1, height, ib = best
    a2, b2 = -b1, a1
    c1 = _f(_f(a1 * P[il][0]) + _f(P[il][1] * b1))
    c2 = _f(_f(a2 * P[ib][0]) + _f(P[ib][1] * b2))
    idet = _f(1.0 / _f(_f(a1 * b2) - _f(a2 * b1)))
    px = _f(_f(_f(c1 * b2) - _f(c2 * b1)) * idet)
    py = _f(_f(_f(a1 * c2) - _f(a2 * c1)) * idet)
    return (px, py), (_f(a1 * width), _f(b1 * width)), (_f(a2 * height), _f(b2 * height))


def min_area_rect(points):
    """cv2.minAreaRect(points) of float32 points (n, 2): ((cx, cy), (w, h),
    angle) as Python floats of float32 values, the angle in degrees in
    [-90, 0)."""
    hull = convex_hull(points)
    n = len(hull)
    P = [(float(x), float(y)) for x, y in hull]
    cx = cy = w = h = 0.0
    deg = 0.0
    if n > 2:
        o0, o1, o2 = _calipers(P)
        cx = _f(o0[0] + _f(_f(o1[0] + o2[0]) * 0.5))
        cy = _f(o0[1] + _f(_f(o1[1] + o2[1]) * 0.5))
        w, h = _f(math.sqrt(o1[0] * o1[0] + o1[1] * o1[1])), _f(math.sqrt(o2[0] * o2[0] + o2[1] * o2[1]))
        deg = math.degrees(math.atan2(o1[1], o1[0]))
    elif n == 2:
        cx, cy = _f(_f(P[0][0] + P[1][0]) * 0.5), _f(_f(P[0][1] + P[1][1]) * 0.5)
        dx, dy = P[1][0] - P[0][0], P[1][1] - P[0][1]
        w = _f(math.sqrt(dx * dx + dy * dy))
        deg = math.degrees(math.atan2(dy, dx))
    elif n == 1:
        cx, cy = P[0]
    while deg >= 0:
        deg, w, h = deg - 90, h, w
    while deg < -90:
        deg, w, h = deg + 90, h, w
    return (cx, cy), (w, h), _f(deg)
