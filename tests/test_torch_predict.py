"""The port's predict path vs the JAX package's: NMS, letterbox, YOLO.predict."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu import YOLO as JaxYOLO
from improving_yolov8_cbam_swinblock_tpu.data.augment import letterbox as jax_letterbox
from improving_yolov8_cbam_swinblock_tpu.ops import boxes as JB
from improving_yolov8_cbam_swinblock_tpu.ops.nms import non_max_suppression as jax_nms
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg
from improving_yolov8_cbam_swinblock_tpu_torch.data.augment import letterbox
from improving_yolov8_cbam_swinblock_tpu_torch.data.build import check_source, load_inference_source
from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import DetectionPredictor
from improving_yolov8_cbam_swinblock_tpu_torch.ops import boxes as TB
from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import MAX_NMS, non_max_suppression
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import jax_variables_from_state
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
CFG = "yolov8n-cbam-swin.yaml"


def random_prediction(rng, b, nc, a, ties):
    """(B, 4+nc, A) xywh boxes and scores; with ties, scores and boxes repeat."""
    xy = rng.uniform(0, 200, (b, 2, a))
    wh = rng.uniform(5, 60, (b, 2, a))
    scores = rng.uniform(0, 1, (b, nc, a))
    if ties:
        scores = np.round(scores * 8) / 8  # few distinct values: many equal scores
        xy[:, :, a // 2:] = xy[:, :, : a - a // 2]  # exact duplicate boxes
        wh[:, :, a // 2:] = wh[:, :, : a - a // 2]
    return np.concatenate([xy, wh, scores], 1).astype(np.float32)


NMS_CASES = [(1, False, 300, False), (1, True, 300, False), (3, True, 300, False), (3, False, 300, False),
             (2, True, MAX_NMS + 500, False),  # truncates at MAX_NMS
             (3, True, 300, True), (3, False, 300, True), (2, True, MAX_NMS + 500, True)]  # agnostic_nms


@pytest.mark.parametrize("nc,ties,a,agnostic", NMS_CASES,
                         ids=[f"{nc}-{t}-{a}" + ("-agnostic" if g else "") for nc, t, a, g in NMS_CASES])
def test_nms_matches_jax_exactly(nc, ties, a, agnostic):
    rng = np.random.default_rng(nc * 10 + ties)
    pred = random_prediction(rng, 3, nc, a, ties)
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=50, nc=nc, agnostic=agnostic)
    ref = np.asarray(jax_nms(jnp.asarray(pred), max_nms=MAX_NMS, **kw))
    out = non_max_suppression(torch.from_numpy(pred), **kw).numpy()
    np.testing.assert_array_equal(out, ref)


def test_nms_pads_when_nothing_passes():
    pred = random_prediction(np.random.default_rng(0), 2, 1, 64, False)
    out = non_max_suppression(torch.from_numpy(pred), conf_thres=2.0, max_det=10, nc=1)
    assert out.shape == (2, 10, 6) and not out.any()


def test_boxes_match_jax():
    rng = np.random.default_rng(1)
    b = rng.uniform(0, 300, (20, 4)).astype(np.float32)
    np.testing.assert_array_equal(TB.xywh2xyxy(torch.from_numpy(b)).numpy(), np.asarray(JB.xywh2xyxy(jnp.asarray(b))))
    xyxy = np.sort(b.reshape(20, 2, 2), axis=1).reshape(20, 4)
    for shapes in [((160, 160), (480, 640)), ((96, 96), (96, 96)), ((320, 320), (100, 37))]:
        np.testing.assert_allclose(TB.scale_boxes(shapes[0], torch.from_numpy(xyxy), shapes[1]).numpy(),
                                   np.asarray(JB.scale_boxes(shapes[0], jnp.asarray(xyxy), shapes[1])), rtol=1e-6)


@pytest.mark.parametrize("shape,size", [((480, 640), 160), ((100, 37), 96), ((96, 96), 96), ((50, 60), 160),
                                        ((333, 97), 128)])
def test_letterbox_matches_jax(shape, size):
    """Geometry exact; pixels within 2 levels (cv2's fixed-point bilinear vs float)."""
    img = np.random.default_rng(2).integers(0, 256, (*shape, 3), dtype=np.uint8)
    img = np.ascontiguousarray(np.repeat(np.repeat(img[::4, ::4], 4, 0), 4, 1)[: shape[0], : shape[1]])
    ref, r_ref, pad_ref = jax_letterbox(img, size)
    out, r, pad = letterbox(img, size, device="cpu")
    assert (r, pad, tuple(out.shape)) == (r_ref, pad_ref, ref.shape)
    assert out.dtype == torch.uint8
    assert np.abs(out.numpy().astype(int) - ref.astype(int)).max() <= 2


def test_predictor_rejects_unknown_sources(tmp_path):
    """What predict still refuses: an object of another type, a path that is
    no image, screen capture (needs `mss`); an array stack is three frames."""
    predictor = DetectionPredictor(None, get_cfg())
    with pytest.raises(TypeError, match="unsupported"):
        predictor._load_sources(object())
    with pytest.raises(TypeError, match="unsupported"):
        check_source({"frames": 1})
    with pytest.raises(FileNotFoundError):
        predictor._load_sources(str(tmp_path / "missing.jpg"))
    (tmp_path / "junk.png").write_bytes(b"not an image")
    with pytest.raises(FileNotFoundError):
        predictor._load_sources([str(tmp_path / "junk.png")])
    with pytest.raises(NotImplementedError, match="mss"):
        load_inference_source("screen 0 10 10 64 64")
    with pytest.raises(TypeError, match="in-memory"):
        load_inference_source(np.zeros((8, 8, 3), np.uint8))
    assert len(predictor._load_sources(np.zeros((3, 8, 8, 3), np.uint8))) == 3


@pytest.fixture(scope="module")
def weights():
    """A seeded port model's weights as JAX variables: the JAX package's init
    schemes and Detect bias priors (nn/tasks.py init_weights), without
    compiling JAX's init of the whole graph."""
    return jax_variables_from_state(DetectionModel(CFG, device="cpu"))


def test_predict_matches_jax(weights):
    """Frames as large as imgsz, so the letterbox is the identity on both sides.
    conf 0.01 keeps the detections of the random model's coarsest level, whose
    class prior (log(5 / 400), sigmoid 0.0123) is the only one above it."""
    frames = [np.random.default_rng(i).integers(0, 256, (96, 96, 3), dtype=np.uint8) for i in range(3)]
    jy = JaxYOLO(CFG)
    jy.variables = weights
    ref = jy.predict(frames, imgsz=96, conf=0.01, batch=2, verbose=False)
    res = YOLO(CFG, device="cpu").load_jax_variables(weights).predict(frames, imgsz=96, conf=0.01, batch=2)
    assert len(res) == len(ref) == 3
    assert sum(len(r) for r in res) > 0
    for r, rr in zip(res, ref):
        assert len(r) == len(rr)
        order, order_ref = np.argsort(-r.boxes.conf, kind="stable"), np.argsort(-rr.boxes.conf, kind="stable")
        np.testing.assert_allclose(r.boxes.data[order], rr.boxes.data[order_ref], rtol=2e-3, atol=2e-2)


def test_predict_rounds_imgsz_and_fuses(weights):
    y = YOLO(CFG, device="cpu").load_jax_variables(weights)
    res = y.predict(np.zeros((70, 90, 3), np.uint8), imgsz=90, conf=0.001, max_det=7)
    assert y.is_fused and len(res) == 1 and len(res[0]) <= 7
    assert res[0].boxes.data.shape[1] == 6 and res[0].orig_shape == (70, 90)
    with pytest.raises(ValueError, match="fuse"):
        y.load_jax_variables(weights)
