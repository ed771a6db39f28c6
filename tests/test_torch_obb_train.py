"""The OBB task's train side in the port vs the JAX package.

min_area_rect (utils/patches.py) against cv2.minAreaRect (OpenCV 5): its
convex hull equal to cv2.convexHull's, and centre, size and angle equal on
axis-aligned integer rectangles and degenerate inputs (duplicates,
collinear points, one point); on rotated rectangles (float or with integer
corners) and general polygons within RECT_TOL of the coordinates' scale
(cv2 rounds some float32 steps otherwise than OpenCV's published rotating
calipers, by a few ulps), the angle in [-90, 0) as cv2 gives it; where cv2
picks another rectangle (a near tie: a quadrilateral whose adjacent edges
are nearly perpendicular), the port's is no larger and cv2's area is
within AREA_TIE of it (cv2 5.0 then returns a rectangle that is not the
least: ROADMAP Queue 3).

The rotated assigner (utils/obb_loss.py) against JAX's
rotated_task_aligned_assign at 160 px (525 anchors, 16 rotated GT boxes an
image, 3 masked out): labels, foreground, GT indices and boxes equal,
scores within 1e-6 (or SCORE_RTOL); obb_loss's total, three items and the grads of the raw
maps and the angles within LOSS_TOL of JAX's (one jax.jit); with an image
without GT or whose first box is dropped, JAX's gradients turn NaN and the
port's stay finite, equal to JAX's where those are finite; and the loss
against tests/golden/obb_loss.npz at the JAX test's rtol 2e-4.

The targets: obb_transform's val and train paths against JAX's on the same
samples and generator seed (mosaic, mixup, rotation, shear, perspective,
flips): x, y, w, h within RECT_TOL and the angles within ANGLE_ATOL, classes,
masks and the generator's state equal, the images within 2 levels
(assert_obb_sample_equal); the OBB loader's
batches against the JAX DataLoader's. OBBValidator against JAX's on a
compact OBB graph's seeded weights over the same 4 images (the metrics
within VAL_TOL). Two micro-steps of the port's trainer against JAX's
_make_train_step on the compact graph (items, parameters, BN statistics
and the EMA within RTOL / ATOL). End to end on the CPU:
YOLO("yolov8n-obb.yaml") trains one epoch with degrees > 0 and validates
with the (B) keys. split_dota writes JAX's crops and labels.
"""

import copy
import functools

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.cfg import get_cfg as jax_get_cfg
from improving_yolov8_cbam_swinblock_tpu.data import augment as JA
from improving_yolov8_cbam_swinblock_tpu.data import dataset as JD
from improving_yolov8_cbam_swinblock_tpu.data import split_dota as JSD
from improving_yolov8_cbam_swinblock_tpu.engine import validator as JV
from improving_yolov8_cbam_swinblock_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from improving_yolov8_cbam_swinblock_tpu.engine.trainer import make_train_state
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.utils.obb_loss import obb_loss as jax_obb_loss
from improving_yolov8_cbam_swinblock_tpu.utils.obb_loss import rotated_task_aligned_assign as jax_assign
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg
from improving_yolov8_cbam_swinblock_tpu_torch.data import augment as PA
from improving_yolov8_cbam_swinblock_tpu_torch.data import dataset as PD
from improving_yolov8_cbam_swinblock_tpu_torch.data import split_dota as PSD
from improving_yolov8_cbam_swinblock_tpu_torch.data.build import build_yolo_dataset
from improving_yolov8_cbam_swinblock_tpu_torch.engine.trainer import DetectionTrainer
from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import OBBValidator
from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda
from improving_yolov8_cbam_swinblock_tpu_torch.utils import settings as PS
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import jax_variables_from_state, state_dict_from_jax
from improving_yolov8_cbam_swinblock_tpu_torch.utils.obb_loss import obb_loss, rotated_task_aligned_assign
from improving_yolov8_cbam_swinblock_tpu_torch.utils.patches import convex_hull, min_area_rect
from tests.seeded_scores import zero_class_priors
from tests.test_torch_model import seeded_variables
from tests.test_torch_obb import OBB_CFG, write_obb_dataset
from tests.test_torch_segment_train import assert_sample_equal
from tests.test_torch_train import ATOL, RTOL, assert_states_match, tree_state
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
LOSS_TOL = 1e-4
RECT_TOL, AREA_TIE = 2e-5, 1e-3
VAL_TOL = 1e-6
SCORE_RTOL = 2e-6
ANGLE_ATOL = 5e-5  # radians
NC, IMGSZ, B, G = 2, 160, 2, 16
A = 525  # anchors at 160 px: 20^2 + 10^2 + 5^2


# ---------------------------------------------------------------------------------------------------------------
# min_area_rect


def _corners(c, wh, a):
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return (np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * np.asarray(wh) / 2) @ rot.T + c


def rect_inputs(kind):
    """Seeded point sets of one kind (float32)."""
    rng = np.random.default_rng({"axis_aligned": 0, "integer": 1, "degenerate": 2, "rectangles": 3,
                                 "polygons": 4}[kind])
    out = []
    if kind == "axis_aligned":  # integer corners (pixels), in any order of the four
        for _ in range(200):
            x, y = rng.integers(-100, 900, 2)
            w, h = rng.integers(1, 300, 2)
            out.append(np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])[rng.permutation(4)])
    elif kind == "integer":  # rotated rectangles with their corners rounded, as labels in pixels are
        for _ in range(300):
            out.append(np.round(_corners(rng.uniform(0, 1024, 2), rng.uniform(2, 300, 2), rng.uniform(-np.pi, np.pi))))
    elif kind == "degenerate":  # integer points: exactly collinear sets (float ones are in "polygons")
        p = rng.integers(0, 100, 2).astype(np.float64)
        out += [np.array([p, p, p, p]), np.array([p]), np.array([p, p + [5, 0]]), np.array([p, p + [0, 5], p])]
        for d in ([1, 0], [0, 1], [1, 1], [1, -1], [3, 1], [-2, 6], [-6, 2], [2, -6]):
            k = rng.permutation(5)
            out.append(p + np.outer(k, d))  # collinear, in either order
        out.append(np.array([p, p, p + [3, 0], p + [3, 4], p + [3, 4]]))  # duplicates in a triangle
    elif kind == "rectangles":
        for _ in range(300):
            a = rng.choice([0.0, np.pi / 2, -np.pi / 2, np.pi]) if rng.random() < 0.2 else rng.uniform(-np.pi, np.pi)
            out.append(_corners(rng.uniform(0, 1024, 2), rng.uniform(2, 300, 2), a))
    else:
        for _ in range(300):
            out.append(rng.uniform(-50, 50, (int(rng.integers(3, 9)), 2)))
        p = rng.uniform(0, 100, 2)  # collinear up to float rounding: a zero-area rectangle
        out += [p + np.outer(rng.permutation(5), d) for d in ([-6, 2], [2, -6], [1, 3])]
    return [np.asarray(q, np.float32) for q in out]


@pytest.mark.parametrize("kind", ["axis_aligned", "integer", "degenerate", "rectangles", "polygons"])
def test_min_area_rect_matches_cv2(kind):
    """The hull equal to cv2.convexHull's; the rectangle equal to
    cv2.minAreaRect's (exact on axis-aligned integer rectangles and
    degenerate integer inputs; within RECT_TOL on the others, a quarter of
    them or more exact; a near tie of two minimal rectangles allowed, and a
    zero-area one of float points collinear up to rounding, whose angle cv2
    may give as -0.0), the port's angle in [-90, 0)."""
    exact = kind in ("axis_aligned", "degenerate")
    equal = 0
    for pts in rect_inputs(kind):
        np.testing.assert_array_equal(convex_hull(pts), cv2.convexHull(pts)[:, 0])
        (cx, cy), (w, h), ang = min_area_rect(pts)
        (rx, ry), (rw, rh), ra = cv2.minAreaRect(pts)
        got, ref = np.float32([cx, cy, w, h, ang]), np.float32([rx, ry, rw, rh, ra])
        assert -90 <= ang < 0
        if np.array_equal(got, ref):
            equal += 1
            continue
        assert not exact, (pts.tolist(), got, ref)
        scale = max(1.0, float(np.abs(pts).max()))
        if np.abs(got[:4] - ref[:4]).max() <= RECT_TOL * scale and abs(got[4] - ref[4]) <= 1e-3:
            continue
        area = lambda r: float(r[2]) * float(r[3])  # noqa: E731  a near tie: two minimal rectangles
        assert abs(area(got) - area(ref)) <= AREA_TIE * area(ref) and area(got) <= area(ref) * (1 + 1e-6), (
            pts.tolist(), got, ref)
    assert equal >= (len(rect_inputs(kind)) if exact else 0.25 * len(rect_inputs(kind)))


# ---------------------------------------------------------------------------------------------------------------
# the assigner and the loss


def loss_inputs():
    """Raw maps (B, 4*16 + nc, H, W) at 160 px, angles (B, A, 1) in
    [-pi/4, 3 pi/4), 16 rotated GT boxes a image on a 4 x 4 grid (3 masked
    out, one with a side under 2 px)."""
    rng = np.random.default_rng(40)
    feats = [rng.normal(0, 1, (B, 64 + NC, IMGSZ // s, IMGSZ // s)).astype(np.float32) for s in (8, 16, 32)]
    ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, A, 1)).astype(np.float32)
    cls = rng.integers(0, NC, (B, G)).astype(np.int32)
    cells = (np.stack(np.meshgrid(np.arange(4), np.arange(4)), -1).reshape(G, 2) + 0.5) / 4
    xy = cells[None] + rng.uniform(-0.03, 0.03, (B, G, 2))
    wh = rng.uniform(0.1, 0.3, (B, G, 2))
    wh[0, 1, 0] = 1.5 / IMGSZ  # under 2 px: dropped
    boxes = np.concatenate([xy, wh, rng.uniform(-np.pi / 2, 0, (B, G, 1))], -1).astype(np.float32)
    mask = np.ones((B, G), np.float32)
    mask[:, -3:] = 0.0
    return feats, ang, cls, boxes, mask


def test_rotated_assigner_matches_jax():
    """The same scores, predicted rotated boxes and GTs: labels, fg, the GT
    indices and the target boxes equal, the scores within 1e-6 or
    SCORE_RTOL (the overlap enters as its sixth power: an ulp of probiou's
    log, exp and sqrt, XLA's against torch's, grows six-fold)."""
    rng = np.random.default_rng(41)
    _, _, cls, boxes, mask = loss_inputs()
    anc = np.concatenate([(np.stack(np.meshgrid(np.arange(n), np.arange(n)), -1).reshape(-1, 2) + 0.5) * s
                          for n, s in ((20, 8), (10, 16), (5, 32))]).astype(np.float32)
    scores = rng.uniform(0, 1, (B, A, NC)).astype(np.float32)
    pd = np.concatenate([anc[None] + rng.normal(0, 4, (B, A, 2)), rng.uniform(8, 60, (B, A, 2)),
                         rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, A, 1))], -1).astype(np.float32)
    gt = boxes * np.array([IMGSZ, IMGSZ, IMGSZ, IMGSZ, 1], np.float32)
    args = (pd, anc, cls[..., None], gt, mask[..., None])
    ref = jax.tree.map(np.asarray, jax.jit(lambda s, *a: jax_assign(s, *a, topk=10, num_classes=NC))(
        scores, *args))
    got = rotated_task_aligned_assign(torch.from_numpy(scores), *(torch.from_numpy(a) for a in args), topk=10,
                                      num_classes=NC)
    labels, tboxes, tscores, fg, idx = ref
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.target_labels.numpy(), labels)
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), idx)
    np.testing.assert_array_equal(got.target_bboxes.numpy(), tboxes)
    np.testing.assert_allclose(got.target_scores.numpy(), tscores, rtol=SCORE_RTOL, atol=1e-6)
    assert fg.sum() > 20 and (tscores > 0).any()


def test_obb_loss_and_grads_match_jax():
    """The total, the items (box, cls, dfl) and the grads of the raw maps
    and the angles within LOSS_TOL of JAX's obb_loss; no kernel launched."""
    feats, ang, cls, boxes, mask = loss_inputs()

    def jax_total(f, a):
        total, items = jax_obb_loss(f, a, cls, boxes, mask, nc=NC)
        return total, jnp.stack([items.box, items.cls, items.dfl])

    (ref_total, ref_items), ref_grads = jax.jit(jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats], jnp.asarray(ang))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    ta = torch.from_numpy(ang).requires_grad_()
    before = tal_assign_cuda.launches
    total, items = obb_loss(tf, ta, torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(mask), nc=NC)
    assert tal_assign_cuda.launches == before
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=LOSS_TOL)
    np.testing.assert_allclose(torch.stack(list(items)).numpy(), np.asarray(ref_items), rtol=LOSS_TOL, atol=1e-7)
    assert all(float(i) > 0 for i in items)
    for f, g in zip(tf, ref_grads[0]):
        np.testing.assert_allclose(f.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g), rtol=LOSS_TOL,
                                   atol=LOSS_TOL * float(np.abs(g).max()))
    g = np.asarray(ref_grads[1])
    np.testing.assert_allclose(ta.grad.numpy(), g, rtol=LOSS_TOL, atol=LOSS_TOL * float(np.abs(g).max()))


@pytest.mark.parametrize("case", ["empty_image", "first_box_dropped"])
def test_obb_loss_grads_stay_finite_where_jax_are_nan(case):
    """An image without GT, or whose first GT box is dropped (a side under 2
    px): JAX's obb_loss gives NaN gradients (a background anchor's probiou
    against the empty GT row 0: the sqrt of a zero determinant, an infinite
    derivative times a zero weight; ROADMAP Queue 3). The port's total and
    items equal JAX's within LOSS_TOL and its gradients are finite, equal
    to JAX's within LOSS_TOL wherever those are finite."""
    feats, ang, cls, boxes, mask = loss_inputs()
    mask, boxes = mask.copy(), boxes.copy()
    if case == "empty_image":
        mask[1] = 0.0
    else:
        boxes[1, 0, 2] = 1.0 / IMGSZ

    def jax_total(f, a):
        total, items = jax_obb_loss(f, a, cls, boxes, mask, nc=NC)
        return total, jnp.stack([items.box, items.cls, items.dfl])

    (ref_total, ref_items), ref_grads = jax.jit(jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats], jnp.asarray(ang))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    ta = torch.from_numpy(ang).requires_grad_()
    total, items = obb_loss(tf, ta, torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(mask), nc=NC)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=LOSS_TOL)
    np.testing.assert_allclose(torch.stack(list(items)).numpy(), np.asarray(ref_items), rtol=LOSS_TOL, atol=1e-7)
    got = [f.grad.permute(0, 2, 3, 1).numpy() for f in tf] + [ta.grad.numpy()]
    ref = [np.asarray(g) for g in ref_grads[0]] + [np.asarray(ref_grads[1])]
    assert not all(np.isfinite(r).all() for r in ref)
    for g, r in zip(got, ref):
        assert np.isfinite(g).all()
        ok = np.isfinite(r)
        np.testing.assert_allclose(g[ok], r[ok], rtol=LOSS_TOL, atol=LOSS_TOL * float(np.abs(r[ok]).max()))


def test_obb_loss_matches_golden():
    """tests/golden/obb_loss.npz (the reference v8OBBLoss on fixed inputs): each item and the total at rtol 2e-4."""
    from pathlib import Path

    d = np.load(Path(__file__).parent / "golden" / "obb_loss.npz")
    feats = [torch.from_numpy(d[f"feats{i}"]).permute(0, 3, 1, 2) for i in range(3)]
    total, items = obb_loss(feats, torch.from_numpy(d["pred_angle"]), torch.from_numpy(d["gt_cls"]),
                            torch.from_numpy(d["gt_xywhrn"]), torch.from_numpy(d["gt_mask"]), nc=int(d["nc"]))
    np.testing.assert_allclose(torch.stack(list(items)).numpy(), d["loss_items"], rtol=2e-4)
    np.testing.assert_allclose(float(total), float(d["loss_total"].sum()), rtol=2e-4)


# ---------------------------------------------------------------------------------------------------------------
# obb_transform and the loader


def obb_sample(i, shape=None):
    """A loader sample: a BGR frame (of `shape`, or one of four) and 1 to 5
    rotated rectangles as 4-corner polygons (normalised), one of every
    fourth sample thin (a side near 1 px)."""
    r = np.random.default_rng(200 + i)
    h, w = shape or [(120, 160), (80, 100), (160, 120), (64, 180)][i % 4]
    img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    n = int(r.integers(1, 6))
    boxes, polys = [], []
    for j in range(n):
        wh = r.uniform(0.15, 0.45, 2) * [w, h]
        if j == 0 and i % 4 == 0:
            wh[1] = 1.2
        q = np.clip(_corners(r.uniform(0.25, 0.75, 2) * [w, h], wh, r.uniform(0, np.pi)), 0, [w, h])
        boxes.append(np.concatenate([q.min(0), q.max(0)]))
        polys.append((q / [w, h]).astype(np.float32))
    return {"img": img, "bboxes": np.array(boxes, np.float32), "cls": (np.arange(n) % NC).astype(np.float32),
            "segments": polys, "kpts": []}


def assert_obb_sample_equal(got, ref):
    """assert_sample_equal for an OBB sample: the boxes' normalised x, y, w,
    h within RECT_TOL and the angles within ANGLE_ATOL (min_area_rect against
    cv2's on the warped polygons: a few ulps of the base direction, at most
    about 5e-4 pixels at 64 px), the rest as there."""
    rest = lambda d: {k: v for k, v in d.items() if k != "bboxes"}  # noqa: E731
    assert_sample_equal(rest(got), rest(ref))
    np.testing.assert_allclose(got["bboxes"][..., :4], ref["bboxes"][..., :4], rtol=0, atol=RECT_TOL)
    np.testing.assert_allclose(got["bboxes"][..., 4], ref["bboxes"][..., 4], rtol=0, atol=ANGLE_ATOL)


HYP = dict(mosaic=1.0, mixup=0.5, degrees=10.0, shear=2.0, perspective=5e-4, translate=0.1, scale=0.5, flipud=0.5,
           fliplr=0.5, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, pixel_augment=1.0, copy_paste=0.0)
CASES = {"val": (False, {}), "train": (True, {}), "train_letterbox": (True, {"mosaic": 0.0, "perspective": 0.0})}


@pytest.mark.parametrize("case", list(CASES))
def test_obb_transform_matches_jax(case):
    """Four seeds each: every key of the sample equal (assert_obb_sample_equal:
    the boxes within RECT_TOL, the angles within ANGLE_ATOL, the images within 2
    levels), the generator in the same state
    after, rotated boxes with angles in [-pi/2, 0) in the targets."""
    train, extra = CASES[case]
    hyp = {**HYP, **extra}
    n = 0
    for t in range(4):
        shape = (96, 128) if case == "train_letterbox" else None
        samples = [obb_sample(t * 8 + k, shape=shape) for k in range(8)]
        rj, rp = np.random.default_rng(t), np.random.default_rng(t)
        ref = JA.obb_transform(samples if train else samples[0], 128, 16, train, rj, hyp)
        got = PA.obb_transform(samples if train else samples[0], 128, 16, train, rp, hyp)
        assert_obb_sample_equal(got, ref)
        assert rj.bit_generator.state == rp.bit_generator.state
        assert got["bboxes"].shape == (16, 5) and got["bboxes"].dtype == np.float32
        ang = got["bboxes"][got["mask"] > 0, 4]
        assert ((ang >= -np.pi / 2) & (ang < 0)).all()
        n += int(got["mask"].sum())
    assert n > 0


@pytest.fixture(scope="module")
def obb_data(tmp_path_factory):
    return write_obb_dataset(tmp_path_factory.mktemp("obbdata"))


@pytest.mark.parametrize("train", [False, True])
def test_obb_loader_matches_jax(obb_data, train):
    """The OBB loader's batches (train: the host stack with mixup; val: the
    letterbox, never rect) against the JAX DataLoader's on the same split:
    the 4-corner labels read as polygons, bboxes (B, max_gt, 5)."""
    info = PD.check_det_dataset(str(obb_data))
    split = info["train" if train else "val"]
    hyp = {**HYP, "mixup": 0.5}
    pl = PD.DataLoader(build_yolo_dataset(get_cfg({"imgsz": 64, "max_gt": 8}), split, info,
                                          mode="train" if train else "val"), 2, train=train, hyp=hyp, workers=1,
                       task="obb", rect_shape=(64, 96))
    jl = JD.DataLoader(JD.YOLODataset(split, imgsz=64, max_gt=8, nc=NC), 2, train=train, hyp=hyp, workers=1,
                       task="obb")
    assert pl.device_augment is False and pl.rect_shape is None
    n = 0
    for got, ref in zip(pl, jl):
        assert_obb_sample_equal(got, ref)
        assert got["bboxes"].shape == (2, 8, 5)
        n += 1
    assert n == len(jl) == 2


# ---------------------------------------------------------------------------------------------------------------
# the validator and the train step on a compact graph


@functools.cache
def compact():
    """The compact OBB graph (tests/test_torch_obb.py OBB_CFG): JAX model,
    the port model from seeded JAX variables with its class priors zeroed
    (scores near 0.5), and those variables read back."""
    jm = JaxDetectionModel(copy.deepcopy(OBB_CFG))
    pm = DetectionModel(copy.deepcopy(OBB_CFG), device="cpu", dtype=torch.float32, param_dtype=torch.float32)
    pm.load_state_dict(state_dict_from_jax(seeded_variables(jm, 64, np.random.default_rng(5))), strict=True)
    zero_class_priors(pm)
    return jm, pm, jax_variables_from_state(pm)


def _injected(batches, imgsz, md=20, seed=9):
    """Each batch's rotated detections (B, md, 7) near its GT boxes (x, y,
    w, h, conf, cls, angle in letterboxed pixels), some of another class."""
    rng = np.random.default_rng(seed)
    outs = []
    for batch in batches:
        b = batch["img"].shape[0]
        dets = np.zeros((b, md, 7), np.float32)
        for i in range(b):
            gt = batch["bboxes"][i][batch["mask"][i] > 0]
            if not len(gt):
                continue
            n = int(rng.integers(1, md))
            k = rng.integers(0, len(gt), n)
            dets[i, :n, :4] = gt[k, :4] * imgsz + rng.normal(0, 1.0, (n, 4))
            dets[i, :n, 6] = gt[k, 4] + rng.normal(0, 0.05, n)
            dets[i, :n, 4] = np.sort(rng.uniform(0.01, 1, n))[::-1]
            dets[i, :n, 5] = np.where(rng.random(n) < 0.8, batch["cls"][i][batch["mask"][i] > 0][k], 1)
        outs.append(dets)
    return outs


@pytest.mark.parametrize("source", ["weights", "detections"])
def test_obb_validator_matches_jax(obb_data, source):
    """The port's OBBValidator and JAX's over the same 4 val images (each
    package's own loader): on the compact graph's weights (each package's
    own forward and rotated NMS), the same number of detections with their
    confidences within 1e-5 and every metric within VAL_TOL; on the same
    injected detections near the GT (both forwards replaced), every metric
    within 1e-12 and some matched."""
    jm, pm, v = compact()
    info = PD.check_det_dataset(str(obb_data))
    args = get_cfg({"imgsz": 64, "max_gt": 8, "batch": 2, "verbose": False, "plots": False})
    ploader = PD.DataLoader(build_yolo_dataset(args, info["val"], info, mode="val"), 2, train=False, workers=1,
                            task="obb")
    pv = OBBValidator(pm, ploader, args)
    jargs = jax_get_cfg(overrides={"imgsz": 64, "max_gt": 8, "batch": 2, "verbose": False})
    jloader = JD.DataLoader(JD.YOLODataset(info["val"], imgsz=64, max_gt=8, nc=NC), 2, train=False, workers=1,
                            task="obb")
    jv = JV.OBBValidator(jm, jloader, jargs)
    if source == "detections":
        outs = _injected(list(ploader), 64)
        pit, jit = iter(outs), iter(outs)
        pv.forward_nms = lambda img: next(pit)
        jv._forward_nms = lambda variables, img: next(jit)
    got, ref = pv(), jv({**v})
    assert set(ref) <= set(got) and len(ref) == 5
    tol = 1e-12 if source == "detections" else VAL_TOL
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=tol), k
    pconf = np.concatenate([st[1] for st in pv.metrics.stats])
    jconf = np.concatenate([st[1] for st in jv.metrics.stats])
    assert len(pconf) == len(jconf) > 0
    np.testing.assert_allclose(np.sort(pconf), np.sort(jconf), rtol=0, atol=1e-5)
    if source == "detections":
        assert got["mAP50"] > 0


def test_two_micro_steps_match_jax():
    """Two micro-steps (SGD, batch 2, fp32) of the compact OBB graph on the
    same seeded batches: the three loss items of each step, then the
    parameters, BN statistics and EMA, within RTOL / ATOL of JAX's trainer."""
    jm, pm0, v = compact()
    overrides = {"batch": 2, "nbs": 2, "epochs": 10, "imgsz": 64, "optimizer": "SGD", "amp": False}
    rng = np.random.default_rng(9)
    data = []
    for _ in range(2):
        bx = np.concatenate([rng.uniform(0.3, 0.7, (2, 6, 2)), rng.uniform(0.15, 0.4, (2, 6, 2)),
                             rng.uniform(-np.pi / 2, 0, (2, 6, 1))], -1).astype(np.float32)
        data.append({"img": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
                     "cls": rng.integers(0, NC, (2, 6)).astype(np.int32), "bboxes": bx,
                     "mask": (rng.random((2, 6)) < 0.8).astype(np.float32)})
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.args = jax_get_cfg(overrides=overrides)
    jt.model = jm
    jstep, _ = jt._make_train_step(nb=100)
    state = make_train_state(v, jt.optimizer_name)
    jitems = []
    for b in data:
        state, m = jstep(state, {k: jnp.asarray(a) for k, a in b.items()})
        jitems.append(np.asarray(m))
    pm = copy.deepcopy(pm0)
    pt = DetectionTrainer(overrides=overrides, model=pm, device="cpu").setup()
    pstep, _ = pt._make_train_step(nb=100)
    pitems = [pstep(b).numpy() for b in data]
    assert pm.task == "obb" and len(pitems[0]) == 3
    for i, (p, j) in enumerate(zip(pitems, jitems)):
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL, err_msg=f"loss items of step {i}")
    assert np.all(jitems[0] > 0)
    ref = tree_state(state.params, state.batch_stats)
    got = {k: t.detach().float().numpy() for k, t in pm.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(ref)
    assert_states_match(got, ref, 0.0, "params/BN")
    assert_states_match({k: t.numpy() for k, t in pt.ema.items()}, tree_state(state.ema_params, state.ema_stats),
                        0.0, "EMA")


# ---------------------------------------------------------------------------------------------------------------
# YOLO end to end on the CPU, and the DOTA tiling


def test_yolo_trains_and_validates_obb(obb_data, tmp_path, monkeypatch):
    """YOLO("yolov8n-obb.yaml", device="cpu"): one epoch of 2 micro-steps at
    64 px in fp32 with degrees 10 (the host stack, the OBB loss, val:
    results.csv with the three loss columns, best.pt), and YOLO(best.pt).val
    equal to the trainer's record, with the (B) keys and `.box`."""
    monkeypatch.setitem(PS.SETTINGS, "tensorboard", False)
    y = YOLO("yolov8n-obb.yaml", device="cpu")
    record = y.train(data=str(obb_data), epochs=1, batch=2, nbs=2, imgsz=64, workers=1, degrees=10.0,
                     project=str(tmp_path / "runs"), verbose=False, amp=False)
    assert y.trainer.step == 2 and y.trainer.train_loader.task == "obb"
    csv = (y.trainer.save_dir / "results.csv").read_text().splitlines()
    assert all(f"train/{k}_loss" in csv[0] for k in ("box", "cls", "dfl")) and "train/seg_loss" not in csv[0]
    assert all(np.isfinite(float(v)) for v in csv[1].split(","))
    best = YOLO(str(y.trainer.wdir / "best.pt"), device="cpu")
    assert best.task == "obb"
    vm = best.val(data=str(obb_data), batch=2, imgsz=64, workers=1, verbose=False)
    assert {k: record[k] for k in record} == pytest.approx({k: vm[k] for k in record}, abs=1e-6)
    assert vm.box is not None and "metrics/mAP50(B)" in vm.results_dict


def test_split_dota_matches_jax(tmp_path):
    """bbox_iof and get_windows equal JAX's; split_trainval of a tiny
    synthetic DOTA folder (two scenes, crops of 64 with gaps of 16) writes
    JAX's crop names, images and labels."""
    rng = np.random.default_rng(8)
    root = tmp_path / "dota"
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i, (h, w) in enumerate([(100, 150), (64, 90)]):
            cv2.imwrite(str(root / "images" / split / f"s{i}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            lines = [f"{k % 3} " + " ".join(f"{v:.5f}" for v in
                                             np.clip(_corners(rng.uniform(0.1, 0.9, 2), rng.uniform(0.05, 0.3, 2),
                                                              rng.uniform(0, np.pi)), 0, 1).reshape(-1))
                     for k in range(6)]
            (root / "labels" / split / f"s{i}.txt").write_text("\n".join(lines) + "\n")
    polys = rng.uniform(0, 200, (7, 8))
    win = PSD.get_windows((180, 260), (64, 100), (16, 20))
    np.testing.assert_array_equal(win, JSD.get_windows((180, 260), (64, 100), (16, 20)))
    np.testing.assert_array_equal(PSD.bbox_iof(polys, win), JSD.bbox_iof(polys, win))
    PSD.split_trainval(str(root), str(tmp_path / "port"), crop_size=64, gap=16)
    JSD.split_trainval(str(root), str(tmp_path / "jax"), crop_size=64, gap=16)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.*"))
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.*"))
    assert len([f for f in files if f.suffix == ".txt"]) > 2
    for f in files:
        a, b = (tmp_path / "port" / f), (tmp_path / "jax" / f)
        if f.suffix == ".png":
            np.testing.assert_array_equal(cv2.imread(str(a)), cv2.imread(str(b)))
        else:
            assert a.read_text() == b.read_text()
