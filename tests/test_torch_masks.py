"""The polygons and drawings of predicted masks in the port vs cv2 and the JAX package.

utils/patches.py find_contours against cv2.findContours(RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE) on 5,000 seeded masks (random noise of every density,
filled and outlined ellipses, rings with blobs in their holes, shapes
cut by the border, one-pixel shapes, lines one pixel wide, empty masks,
masks of any nonzero value): the same contours in the same order, each
with the same start point, direction and points, bit for bit; and
contour_area against cv2.contourArea, exactly. Then masks2segments, Masks.xy
and xyn, the `segments` column of Results.summary / to_json, save_txt,
Annotator.masks (resize_nearest against cv2.INTER_NEAREST) and the masks
drawn by Results.plot against the JAX package's, which calls cv2, on the
same masks: equal bit for bit.
"""

import json

import cv2
import numpy as np
import pytest

from improving_yolov8_cbam_swinblock_tpu.engine.results import Masks as JaxMasks
from improving_yolov8_cbam_swinblock_tpu.engine.results import Results as JaxResults
from improving_yolov8_cbam_swinblock_tpu.ops.segments import masks2segments as jax_masks2segments
from improving_yolov8_cbam_swinblock_tpu.utils.plotting import Annotator as JaxAnnotator
from improving_yolov8_cbam_swinblock_tpu_torch.engine.results import Masks, Results
from improving_yolov8_cbam_swinblock_tpu_torch.ops.segments import masks2segments
from improving_yolov8_cbam_swinblock_tpu_torch.utils.patches import contour_area, find_contours
from improving_yolov8_cbam_swinblock_tpu_torch.utils.plotting import Annotator, resize_nearest

KINDS = ("noise", "ellipses", "nested", "border", "pixels")
PER_KIND = 1000  # masks per kind: 5,000 in all


def random_mask(kind: str, rng) -> np.ndarray:
    """One seeded uint8 mask of the given kind, 1 to 48 pixels a side."""
    h, w = (int(v) for v in rng.integers(1, 49, 2))
    m = np.zeros((h, w), np.uint8)
    if kind == "noise":  # every density, from empty to full
        m = (rng.random((h, w)) < rng.uniform(0.0, 1.0)).astype(np.uint8)
    elif kind in ("ellipses", "border"):  # filled and outlined ellipses; "border": centred near or past an edge
        for _ in range(int(rng.integers(1, 6))):
            if kind == "border":
                c = (int(rng.choice([0, w - 1, -2, w + 1])), int(rng.integers(-3, h + 3)))
            else:
                c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            axes = (int(rng.integers(0, 16)), int(rng.integers(0, 16)))
            cv2.ellipse(m, c, axes, float(rng.uniform(0, 180)), 0, 360, int(rng.integers(0, 2)),
                        int(rng.choice([-1, 1, 2])))
        m ^= (rng.random((h, w)) < 0.03).astype(np.uint8)
    elif kind == "nested":  # rings one or two pixels thick with blobs, rings and single pixels in their holes
        h, w = max(h, 12), max(w, 12)
        m = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            r = int(rng.integers(4, 14))
            cv2.circle(m, c, r, 1, int(rng.integers(1, 3)))
            cv2.circle(m, c, int(rng.integers(0, max(r - 3, 1))), 1, int(rng.choice([-1, 1])))
            m[c[1] % h, (c[0] + r // 2) % w] = 1
    else:  # "pixels": single pixels, lines one pixel wide, and empty masks
        if rng.random() < 0.2:
            return m
        n = int(rng.integers(1, 12))
        m[rng.integers(0, h, n), rng.integers(0, w, n)] = 1
        for _ in range(int(rng.integers(0, 3))):
            p = rng.integers(-2, max(h, w) + 2, 4)
            cv2.line(m, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])), 1, 1)
    if rng.random() < 0.2:  # any nonzero value is foreground
        m = m * rng.integers(1, 256, m.shape).astype(np.uint8)
    return m


def cv2_contours(m):
    return [c.reshape(-1, 2) for c in cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]]


@pytest.mark.parametrize("kind", KINDS)
def test_find_contours_equals_cv2(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    off, contours = [], 0
    for i in range(PER_KIND):
        m = random_mask(kind, rng)
        got, ref = find_contours(m), cv2_contours(m)
        same = len(got) == len(ref) and all(g.dtype == np.int32 and np.array_equal(g, r) for g, r in zip(got, ref))
        same = same and all(contour_area(g) == cv2.contourArea(r) for g, r in zip(got, ref))
        if not same:
            off.append(i)
        contours += len(ref)
    assert not off, f"{len(off)} of {PER_KIND} masks off, the first at {off[:5]}"
    assert contours >= PER_KIND // 2


def test_contour_area_of_float_polygons_and_empty():
    rng = np.random.default_rng(9)
    for _ in range(50):
        p = rng.uniform(-50, 50, (int(rng.integers(1, 12)), 2)).astype(np.float32)
        assert contour_area(p) == cv2.contourArea(p)
    assert contour_area(np.zeros((0, 2), np.float32)) == 0.0


def seg_masks(n=7, h=60, w=80, seed=3):
    """(n, h, w) bool masks: blobs, some in two pieces, one with a hole, one empty, one touching the border."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, h, w), np.uint8)
    for i in range(n - 1):
        for _ in range(1 + i % 2):
            c = (int(rng.integers(-5, w + 5)), int(rng.integers(-5, h + 5)))
            cv2.ellipse(out[i], c, (int(rng.integers(3, 25)), int(rng.integers(3, 20))), float(rng.uniform(0, 180)),
                        0, 360, 1, -1)
    cv2.circle(out[2], (40, 30), 6, 0, -1)
    return out.astype(bool)


@pytest.mark.parametrize("strategy", ["all", "largest"])
def test_masks2segments_matches_jax(strategy):
    masks = seg_masks()
    got, ref = masks2segments(masks, strategy), jax_masks2segments(masks, strategy)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("orig", [(60, 80), (120, 200)])
def test_masks_xy_and_xyn_match_jax(orig):
    """At the original resolution and, for masks at a lower one, scaled to it."""
    masks = seg_masks()
    got, ref = Masks(masks, orig), JaxMasks(masks, orig)
    for a, b in ((got.xy, ref.xy), (got.xyn, ref.xyn)):
        assert len(a) == len(b) == len(masks)
        for g, r in zip(a, b):
            assert g.dtype == r.dtype == np.float32
            np.testing.assert_array_equal(g, r)
    assert got.xy[-1].shape == (0, 2)


def results_pair(with_masks=True, n=5):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    xy = rng.uniform(0, 50, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2)), rng.uniform(0.3, 1, (n, 1)),
                            rng.integers(0, 3, (n, 1))], 1).astype(np.float32)
    names = {0: "a", 1: "b", 2: "c"}
    got, ref = Results(img, "im.jpg", names, boxes), JaxResults(img, "im.jpg", names, boxes)
    if with_masks:
        masks = seg_masks(n)
        got.update(masks=masks)
        ref.masks = JaxMasks(masks, img.shape[:2])
    return got, ref


def test_summary_and_json_segments_match_jax():
    got, ref = results_pair()
    assert got.summary() == ref.summary() and "segments" in got.summary()[0]
    assert json.loads(got.to_json()) == json.loads(json.dumps(ref.summary()))
    plain = results_pair(with_masks=False)
    assert plain[0].summary() == plain[1].summary() and "segments" not in plain[0].summary()[0]


def test_seg_save_txt_writes_boxes_as_jax(tmp_path):
    """A segmentation result's label lines are its boxes (no polygon), as the JAX package writes them."""
    got, ref = results_pair()
    for save_conf in (False, True):
        a, b = tmp_path / f"port{save_conf}.txt", tmp_path / f"jax{save_conf}.txt"
        got.save_txt(str(a), save_conf), ref.save_txt(str(b), save_conf)
        assert a.read_text() == b.read_text() and len(a.read_text().splitlines()) == len(got)


@pytest.mark.parametrize("size", [(60, 80), (15, 20), (45, 130)])
def test_plot_draws_masks_as_jax(size):
    """Results.plot with masks at the image's resolution and at others
    (cv2.resize's linear rule, then > 0): the same image as JAX's, bit for bit."""
    got, ref = results_pair()
    masks = np.stack([cv2.resize(m.astype(np.uint8), size[::-1], interpolation=cv2.INTER_NEAREST) for m in
                      seg_masks()[:len(got)]]).astype(bool)
    got.masks, ref.masks = Masks(masks, got.orig_shape), JaxMasks(masks, ref.orig_shape)
    np.testing.assert_array_equal(got.plot(), ref.plot())


def test_resize_nearest_equals_cv2():
    rng = np.random.default_rng(6)
    for _ in range(300):
        sh, sw, h, w = (int(v) for v in rng.integers(1, 200, 4))
        m = rng.integers(0, 2, (sh, sw)).astype(np.uint8)
        np.testing.assert_array_equal(resize_nearest(m, (h, w)), cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST))
    m = rng.integers(0, 2, (160, 160)).astype(np.uint8)
    np.testing.assert_array_equal(resize_nearest(m, (480, 640)), cv2.resize(m, (640, 480), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_annotator_masks_matches_jax(alpha):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    masks = seg_masks()
    small = np.stack([cv2.resize(m.astype(np.uint8), (37, 23), interpolation=cv2.INTER_NEAREST) for m in masks])
    colors = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in masks]
    for m in (masks, small):
        a, b = Annotator(img.copy()), JaxAnnotator(img.copy())
        a.masks(m, colors, alpha)
        b.masks(m, colors, alpha)
        np.testing.assert_array_equal(a.result(), b.result())
        assert not np.array_equal(a.result(), img)
