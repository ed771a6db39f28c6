"""The segment task's train side in the port vs the JAX package.

The seg loss (utils/seg_loss.py) against JAX's segmentation_loss on the same
inputs, with 525 anchors of which more than 256 are foreground (64 GT boxes) (so the
top-256 cut by assignment weight, the first index among equal weights,
decides which anchors' masks count), in both target layouts: the overlap
map at the prototypes' resolution, and int32 bit planes at twice it
(overlap_mask=False with mask_ratio 2: the nearest resize). The total, the
four items (box, seg, cls, dfl) and the grads of the raw maps, the mask
coefficients and the prototypes within 1e-4 of the largest magnitude (fp32
sums in another order; one jax.jit per layout). The loss also equals
tests/golden/seg_loss.npz at the JAX test's rtol=2e-4.

The targets: segment_transform's val and train paths against JAX's on the
same samples and generator seed (mosaic, mixup, the warps, flips; both
target layouts and mask_ratio 2): seg_map, boxes, classes and the
generator's state exactly, the images within 2 levels, with copy_paste in
flip mode and in mixup mode (mixup on and off: mixup's draw comes all the
same); copy_paste_inst itself in both modes bit for bit; the loader's
segment batches against the JAX DataLoader's, with copy_paste in both modes
(mixup mode draws four more donors); a copy_paste_mode other than flip or
mixup refused; the validator on detections in an image without GT.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.data import augment as JA
from improving_yolov8_cbam_swinblock_tpu.data import dataset as JD
from improving_yolov8_cbam_swinblock_tpu.utils.seg_loss import segmentation_loss as jax_segmentation_loss
from improving_yolov8_cbam_swinblock_tpu_torch.data import augment as PA
from improving_yolov8_cbam_swinblock_tpu_torch.data import dataset as PD
from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import SegmentationValidator
from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda
from improving_yolov8_cbam_swinblock_tpu_torch.utils.loss import detect_terms
from improving_yolov8_cbam_swinblock_tpu_torch.utils.seg_loss import nearest_index, segmentation_loss
from tests.test_torch_segment import write_polygon_dataset
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
LOSS_TOL = 1e-4
GOLDEN_RTOL = 2e-4
NC, NM, IMGSZ, B, G = 2, 32, 160, 2, 64
A = 525  # anchors at 160 px: 20^2 + 10^2 + 5^2
IMAGE_LEVELS = 2  # the host stack's image bound (tests/test_torch_host_augment.py)


def test_seg_loss_matches_golden():
    """tests/golden/seg_loss.npz (the reference loss on fixed inputs): each item at rtol 2e-4."""
    from pathlib import Path

    d = np.load(Path(__file__).parent / "golden" / "seg_loss.npz")
    feats = [torch.from_numpy(d[f"feats{i}"]).permute(0, 3, 1, 2) for i in range(3)]
    total, items = segmentation_loss(feats, torch.from_numpy(d["mask_coeffs"]),
                                     torch.from_numpy(d["protos"]).permute(0, 3, 1, 2), torch.from_numpy(d["gt_cls"]),
                                     torch.from_numpy(d["gt_xywhn"]), torch.from_numpy(d["gt_mask"]),
                                     torch.from_numpy(d["seg_map"]), nc=int(d["nc"]))
    np.testing.assert_allclose(items.numpy(), d["loss_items"], rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(float(total), float(d["loss_total"].sum()), rtol=GOLDEN_RTOL)


def loss_inputs(bitplanes: bool):
    """Raw maps (B, 4*16 + nc, H, W) at 160 px, coefficients, prototypes at
    40 x 40, 64 GT boxes per image on an 8 x 8 grid (6 masked out) and
    their targets: the overlap map (40 x 40, larger boxes first) or bit
    planes at 80 x 80."""
    rng = np.random.default_rng(5 + bitplanes)
    feats = [rng.normal(0, 1, (B, 64 + NC, IMGSZ // s, IMGSZ // s)).astype(np.float32) for s in (8, 16, 32)]
    coeffs = rng.normal(0, 0.5, (B, A, NM)).astype(np.float32)
    protos = rng.normal(0, 1, (B, NM, IMGSZ // 4, IMGSZ // 4)).astype(np.float32)
    cls = rng.integers(0, NC, (B, G)).astype(np.int32)
    cells = (np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(G, 2) + 0.5) / 8
    xy = cells[None] + rng.uniform(-0.02, 0.02, (B, G, 2))
    wh = rng.uniform(0.1, 0.16, (B, G, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.ones((B, G), np.float32)
    mask[:, -6:] = 0.0
    s = IMGSZ // 2 if bitplanes else IMGSZ // 4
    if bitplanes:
        seg = np.zeros((B, 2, s, s), np.int32)
    else:
        seg = np.zeros((B, s, s), np.int32)
    for b in range(B):
        order = np.argsort(-(wh[b, :, 0] * wh[b, :, 1]))
        for j in order:
            x1, y1 = ((xy[b, j] - wh[b, j] / 2) * s).astype(int)
            x2, y2 = ((xy[b, j] + wh[b, j] / 2) * s).astype(int)
            shrink = rng.integers(0, 3, 2)  # a mask smaller than its box
            if bitplanes:
                one = np.zeros((s, s), np.int32)
                one[max(y1, 0) + shrink[0]:y2, max(x1, 0) + shrink[1]:x2] = 1
                seg[b, j // 32] |= one << (j % 32)
            else:
                seg[b, max(y1, 0) + shrink[0]:y2, max(x1, 0) + shrink[1]:x2] = j + 1
    return feats, coeffs, protos, cls, boxes, mask, seg


@pytest.mark.parametrize("bitplanes", [False, True], ids=["overlap_map", "bit_planes_ratio2"])
def test_seg_loss_and_grads_match_jax(bitplanes):
    feats, coeffs, protos, cls, boxes, mask, seg = loss_inputs(bitplanes)

    def jax_total(f, c, p):
        total, items, s = jax_segmentation_loss(f, c, p, cls, boxes, mask, seg, nc=NC, nm=NM)
        return total, jnp.stack([items.box, s, items.cls, items.dfl])

    (ref_total, ref_items), ref_grads = jax.jit(jax.value_and_grad(jax_total, argnums=(0, 1, 2), has_aux=True))(
        [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats], jnp.asarray(coeffs),
        jnp.asarray(protos.transpose(0, 2, 3, 1)))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    tc, tp = torch.from_numpy(coeffs).requires_grad_(), torch.from_numpy(protos).requires_grad_()
    total, items = segmentation_loss(tf, tc, tp, torch.from_numpy(cls), torch.from_numpy(boxes),
                                     torch.from_numpy(mask), torch.from_numpy(seg), nc=NC)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=LOSS_TOL)
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=LOSS_TOL)
    for f, g in zip(tf, ref_grads[0]):
        np.testing.assert_allclose(f.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g), rtol=LOSS_TOL,
                                   atol=LOSS_TOL * float(np.abs(g).max()))
    for got, g in ((tc.grad.numpy(), ref_grads[1]), (tp.grad.permute(0, 2, 3, 1).numpy(), ref_grads[2])):
        np.testing.assert_allclose(got, np.asarray(g), rtol=LOSS_TOL, atol=LOSS_TOL * float(np.abs(g).max()))
    # more foreground anchors than the 256 masks kept: the cut by weight decides; only the kept get coefficient grads
    fg = detect_terms([torch.from_numpy(f) for f in feats], torch.from_numpy(cls), torch.from_numpy(boxes),
                      torch.from_numpy(mask), NC, 16, (8, 16, 32), 10, None).assigned.fg_mask.sum(1)
    assert int(fg.max()) > 256 and float(items[1]) > 0
    assert int((tc.grad.abs().sum(-1) > 0).sum(1).max()) == 256


def test_nearest_index_matches_jax_resize():
    for n_in, n_out in ((80, 160), (160, 80), (50, 37), (37, 50)):
        ref = np.asarray(jax.image.resize(jnp.arange(n_in, dtype=jnp.int32), (n_out,), method="nearest"))
        np.testing.assert_array_equal(nearest_index(n_in, n_out).numpy(), ref)


def test_seg_loss_runs_the_plain_assigner_on_the_cpu():
    """On the CPU the loss's assigner takes its plain version: no K2 launch."""
    feats, coeffs, protos, cls, boxes, mask, seg = loss_inputs(False)
    before = tal_assign_cuda.launches
    segmentation_loss([torch.from_numpy(f) for f in feats], torch.from_numpy(coeffs), torch.from_numpy(protos),
                      torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(mask), torch.from_numpy(seg),
                      nc=NC)
    assert tal_assign_cuda.launches == before


# ---------------------------------------------------------------------------------------------------------------
# targets


def polygon_sample(i, n=None, shape=None):
    """A loader sample: a BGR frame (of `shape`, or one of four), 1 to 5
    instances, the last of every third sample a box-only label (segments None)."""
    r = np.random.default_rng(i)
    h, w = shape or [(120, 160), (80, 100), (160, 120), (64, 180)][i % 4]
    img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    n = n or int(r.integers(1, 6))
    segs, boxes = [], []
    for j in range(n):
        c, rad = r.uniform(0.25, 0.75, 2), r.uniform(0.15, 0.35)
        k = int(r.integers(3, 12))
        ang = np.sort(r.uniform(0, 2 * np.pi, k))
        p = np.clip(np.stack([c[0] + rad * np.cos(ang) * r.uniform(0.5, 1.2, k),
                              c[1] + rad * np.sin(ang) * r.uniform(0.5, 1.2, k)], 1), 0, 1).astype(np.float32)
        if j == n - 1 and i % 3 == 0:
            segs.append(None)
            bb = np.array([0.3, 0.3, 0.6, 0.7], np.float32)
        else:
            segs.append(p)
            bb = np.array([p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()], np.float32)
        boxes.append(bb * np.array([w, h, w, h], np.float32))
    return {"img": img, "bboxes": np.array(boxes, np.float32), "cls": (np.arange(n) % NC).astype(np.float32),
            "segments": segs}


HYP = dict(mosaic=1.0, mixup=0.5, degrees=10.0, shear=2.0, perspective=5e-4, translate=0.1, scale=0.5, flipud=0.5,
           fliplr=0.5, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, pixel_augment=1.0, copy_paste=0.0)
CASES = {"val": (False, {}), "train": (True, {}), "train_bit_planes": (True, {"overlap_mask": False}),
         "train_ratio2": (True, {"mask_ratio": 2}), "train_letterbox": (True, {"mosaic": 0.0, "perspective": 0.0}),
         "train_copy_paste_flip": (True, {"copy_paste": 0.5}),
         "train_copy_paste_mixup": (True, {"copy_paste": 0.5, "copy_paste_mode": "mixup"}),
         "train_copy_paste_mixup_no_mixup": (True, {"copy_paste": 1.0, "copy_paste_mode": "mixup", "mixup": 0.0})}
# the letterbox case's frames are IMGSZ on their long side: PyTorch's bilinear resize is not cv2's (a level or
# two), which the HSV gains then scale; the host stack's tests hold it on frames that need no resize too


def assert_sample_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "img":
            assert np.abs(got[k].astype(int) - ref[k]).max() <= IMAGE_LEVELS
        elif k == "bboxes":
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_segment_transform_matches_jax(case):
    """Five seeds each: every key of the sample equal (the images within 2
    levels), the generator in the same state after, and instances in the
    targets."""
    train, extra = CASES[case]
    hyp = {**HYP, **extra}
    instances = 0
    for t in range(5):
        shape = (96, IMGSZ) if case == "train_letterbox" else None
        samples = [polygon_sample(t * 8 + k, shape=shape) for k in range(8)]
        rj, rp = np.random.default_rng(t), np.random.default_rng(t)
        ref = JA.segment_transform(samples if train else samples[0], IMGSZ, 16, train, rj, hyp)
        got = PA.segment_transform(samples if train else samples[0], IMGSZ, 16, train, rp, hyp)
        assert_sample_equal(got, ref)
        assert rj.bit_generator.state == rp.bit_generator.state
        instances += int(ref["mask"].sum())
        shape = (IMGSZ // hyp.get("mask_ratio", 4),) * 2 if train else (IMGSZ // 4,) * 2
        assert got["seg_map"].shape[-2:] == shape and got["seg_map"].dtype == np.int32
    assert instances >= 5 and (got["seg_map"].ndim == 3) == (case == "train_bit_planes")


def test_polygon_helpers_match_jax():
    """segment2box, segments2boxes and resample_segments (ops/segments.py) equal JAX's, empty polygons included."""
    from improving_yolov8_cbam_swinblock_tpu.ops import segments as JS
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import segments as PS

    rng = np.random.default_rng(8)
    polys = [rng.uniform(-20, 120, (int(rng.integers(1, 9)), 2)).astype(np.float32) for _ in range(12)]
    polys.append(np.zeros((0, 2), np.float32))
    for p in polys:
        np.testing.assert_array_equal(PS.segment2box(p, 100, 80), JS.segment2box(p, 100, 80))
    np.testing.assert_array_equal(PS.segments2boxes(polys), JS.segments2boxes(polys))
    for a, b in zip(PS.resample_segments(polys, 50), JS.resample_segments(polys, 50)):
        np.testing.assert_array_equal(a, b)


def test_copy_paste_raises():
    """A copy_paste_mode other than flip or mixup raises ValueError, as the
    JAX package's get_cfg does; copy_paste above 0 runs (it raised before
    copy_paste_inst came to the port)."""
    from improving_yolov8_cbam_swinblock_tpu.cfg import get_cfg as jax_get_cfg
    from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg

    for fn in (get_cfg, jax_get_cfg):
        with pytest.raises(ValueError, match="copy_paste_mode"):
            fn({"copy_paste_mode": "paste"})
    assert get_cfg({"copy_paste": 0.5, "copy_paste_mode": "mixup"}).copy_paste_mode == "mixup"
    out = PA.segment_transform([polygon_sample(k) for k in range(4)], IMGSZ, 16, True, np.random.default_rng(0),
                               {**HYP, "copy_paste": 0.5})
    assert out["img"].shape == (IMGSZ, IMGSZ, 3)


def inst_case(seed, n_donor=3):
    """Pixel-space instance samples for copy_paste_inst: the image's own and
    a donor's (of the same size), polygons beside boxes, one box-only label."""
    def inst(i):
        s = polygon_sample(seed * 10 + i, shape=(IMGSZ, IMGSZ))
        return JA._inst_px(s)

    return inst(0), inst(1)


@pytest.mark.parametrize("mode", ["flip", "mixup"])
def test_copy_paste_inst_matches_jax(mode):
    """copy_paste_inst against JAX's on the same instance samples and p (flip:
    the sample's own mirrored instances; mixup: a donor's): the image, boxes,
    classes and polygons bit for bit, and instances pasted in some cases."""
    pasted = 0
    for seed in range(8):
        s, donor = inst_case(seed)
        for p in (0.3, 0.5, 1.0):
            ref = JA.copy_paste_inst(s, np.random.default_rng(0), p, donor if mode == "mixup" else None)
            got = PA.copy_paste_inst({k: s[k] for k in ("img", "bboxes", "cls", "polys")}, np.random.default_rng(0),
                                     p, donor if mode == "mixup" else None)
            np.testing.assert_array_equal(got["img"], ref["img"])
            np.testing.assert_array_equal(got["bboxes"], ref["bboxes"])
            np.testing.assert_array_equal(got["cls"], ref["cls"])
            assert got["cls"].dtype == ref["cls"].dtype and len(got["polys"]) == len(ref["polys"])
            for a, b in zip(got["polys"], ref["polys"]):
                assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
            pasted += len(got["cls"]) - len(s["cls"])
    assert pasted > 0


@pytest.fixture(scope="module")
def polygon_data(tmp_path_factory):
    return write_polygon_dataset(tmp_path_factory.mktemp("segdata"))


@pytest.mark.parametrize("train", [False, True])
def test_segment_loader_matches_jax(polygon_data, train):
    """The segment loader's batches (train: the host stack with mixup; val:
    the letterbox, never rect) against the JAX DataLoader's on the same files."""
    split = "train" if train else "val"
    root = polygon_data.parent / "images" / split
    hyp = {**HYP, "mixup": 0.5}
    jl = JD.DataLoader(JD.YOLODataset(str(root), imgsz=64, max_gt=8, nc=NC), 2, train=train, hyp=hyp, workers=1,
                       task="segment")
    pl = PD.DataLoader(PD.YOLODataset(str(root), imgsz=64, max_gt=8, nc=NC), 2, train=train, hyp=hyp, workers=1,
                       task="segment", rect_shape=(64, 96))
    assert pl.device_augment is False and pl.rect_shape is None
    n = 0
    for got, ref in zip(pl, jl):
        assert_sample_equal(got, ref)
        n += 1
    assert n == len(jl) == 2


@pytest.mark.parametrize("mode", ["flip", "mixup"])
def test_segment_loader_copy_paste_matches_jax(polygon_data, mode):
    """The train loader with copy_paste 0.5 in each mode (mixup mode: four
    more donors drawn with the others, in the JAX loader's order) against
    the JAX DataLoader's batches."""
    root = polygon_data.parent / "images" / "train"
    hyp = {**HYP, "mixup": 0.5, "copy_paste": 0.5, "copy_paste_mode": mode}
    jl = JD.DataLoader(JD.YOLODataset(str(root), imgsz=64, max_gt=8, nc=NC), 2, train=True, hyp=hyp, workers=1,
                       task="segment")
    pl = PD.DataLoader(PD.YOLODataset(str(root), imgsz=64, max_gt=8, nc=NC), 2, train=True, hyp=hyp, workers=1,
                       task="segment")
    n = 0
    for got, ref in zip(pl, jl):
        assert_sample_equal(got, ref)
        n += 1
    assert n == len(jl) == 2


def test_segmentation_validator_counts_detections_without_gt():
    """An image with detections and no GT: its detections count as false
    positives of both metrics (JAX's validator fails there)."""
    from types import SimpleNamespace

    args = SimpleNamespace(imgsz=64, max_det=4, verbose=False, plots=False, save_json=False, project=None, name=None)
    model = SimpleNamespace(names={0: "a", 1: "b"}, nc=NC, eval=lambda: None)
    seg_map = np.zeros((2, 16, 16), np.int32)
    seg_map[0, 2:8, 2:8] = 1
    batch = {"img": np.zeros((2, 64, 64, 3), np.uint8), "cls": np.zeros((2, 2), np.float32),
             "bboxes": np.array([[[0.3125, 0.3125, 0.375, 0.375], [0, 0, 0, 0]]] * 2, np.float32),
             "mask": np.array([[1, 0], [0, 0]], np.float32), "seg_map": seg_map}
    dets = np.zeros((2, 4, 6), np.float32)
    dets[:, 0] = [8, 8, 32, 32, 0.9, 0]
    masks = [(seg_map[0] == 1)[None], (seg_map[0] == 1)[None]]
    v = SegmentationValidator(model, [batch], args)
    v.forward_nms = lambda img: (dets, masks)
    out = v()
    assert out["precision(M)"] == pytest.approx(0.5) and out["recall(M)"] == pytest.approx(1.0)
