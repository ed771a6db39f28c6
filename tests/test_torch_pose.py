"""Pose estimation in the port vs the JAX package, on the same weights and inputs.

Head and graphs: the Pose head at module level (its v8 cls branch, nc 2,
four keypoints of 3 and of 2 values) in eval mode (the decoded (B, 4 + nc
+ nk * nd, A) prediction, the raw maps and the raw keypoints) and in train
mode (raw maps, raw keypoints, the moved BatchNorm statistics), within
1e-5 (MOD_TOL: the same fp32 math summed in another order), one jax.jit per
keypoint shape; yolov8n-pose (the v8 cls branch, kpt_shape written inline)
and yolo11n-pose (YOLO11's, kpt_shape by name) at 64 px, nc 2, on seeded
JAX variables bridged into the port, unfused, BN-folded by the port and
(yolov8n-pose) from JAX's BN-folded tree, within 2e-3 (GRAPH_TOL, of the largest magnitude: ~60 fp32 layers summed in
another order), one jax.jit per graph; yolov8n-pose-p6 and yolo12n-pose:
every parameter and statistic name and shape against JAX's abstract trace
(shape_init, no compile); the weight bridge both ways, bit for bit, and the
.ckpt and .pt round trips; an ensemble refuses a pose member.

Post-processing: NMS carries the keypoint columns of JAX's prediction bit
for bit; the predictor's keypoints (scale_coords with the letterbox's gain
and integer pad, clipped) equal the JAX predictor's _postprocess_one on the
same rows bit for bit; kpt_iou_np equals JAX's; PoseValidator's metrics
equal JAX's on the same detections and targets (1e-12). Results:
Keypoints, summary (JAX's x and y, plus the reference's visible),
save_txt, plot and Annotator.kpts equal JAX's. int8: quantizing
yolov8n-pose calibrates the convs JAX's calibration pass records (its
abstract trace) and leaves each cv4.i.2 float. A pose program through
YOLO(path) equals the live model at batches 1 and 3; YOLO.track keeps the
keypoints in the detections' order, as the JAX package does.
"""

import copy
import functools
import json
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.engine import results as JR
from improving_yolov8_cbam_swinblock_tpu.engine import validator as JV
from improving_yolov8_cbam_swinblock_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from improving_yolov8_cbam_swinblock_tpu.nn import heads as JH
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.ops.nms import non_max_suppression as jax_nms
from improving_yolov8_cbam_swinblock_tpu.utils import metrics as JME
from improving_yolov8_cbam_swinblock_tpu.utils.fuse import fuse_variables
from improving_yolov8_cbam_swinblock_tpu.utils.plotting import Annotator as JaxAnnotator
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, EnsembleModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg
from improving_yolov8_cbam_swinblock_tpu_torch.data.augment import letterbox_geometry
from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import DetectionPredictor
from improving_yolov8_cbam_swinblock_tpu_torch.engine.results import Keypoints, Results
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
from improving_yolov8_cbam_swinblock_tpu_torch.ops import quant as Q
from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import non_max_suppression
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import (fused_state_from_jax,
                                                                         jax_variables_from_state,
                                                                         state_dict_from_jax)
from improving_yolov8_cbam_swinblock_tpu_torch.utils.metrics import OKS_SIGMA, kpt_iou_np
from improving_yolov8_cbam_swinblock_tpu_torch.utils.plotting import Annotator
from tests.int8_parity import to_port_calib
from tests.seeded_scores import zero_class_priors
from tests.test_torch_model import seeded_variables
from tests.test_torch_v10 import MOD_TOL, assert_stats_moved, load_module
from tests.test_torch_yolo11 import close, nhwc, seeded_module, to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
GRAPH_TOL = 2e-3
NC = 2
GRAPHS = ("yolov8n-pose.yaml", "yolo11n-pose.yaml")
FRAMES = np.random.default_rng(65).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)  # RGB
GRAPH_X = FRAMES.astype(np.float32) / 255.0
HEAD_CH = (16, 32, 64)  # Pose's input channels at module level; maps 8x8, 4x4, 2x2 (a 64 px input)


def cfg_nc(cfg, nc=NC):
    d = yaml_model_load(cfg)
    d["nc"] = nc
    return d


# ---------------------------------------------------------------------------------------------------------------
# the head


@functools.cache
def head_run(nd):
    """Pose with four keypoints of nd values at module level: seeded
    variables, inputs, its eval output, train output and moved batch_stats, one jax.jit."""
    rng = np.random.default_rng(20 + nd)
    xs = [rng.normal(0, 1, (2, 8 // 2**i, 8 // 2**i, c)).astype(np.float32) for i, c in enumerate(HEAD_CH)]
    jm = JH.Pose(nc=NC, kpt_shape=(4, nd), ch=HEAD_CH)
    v = seeded_module(jm, [jnp.asarray(x) for x in xs], rng)

    def run(vv, xx):
        train, moved = jm.apply(vv, xx, train=True, mutable=["batch_stats"])
        return jm.apply(vv, xx, train=False), train, moved["batch_stats"]

    return v, xs, jax.tree.map(np.asarray, jax.jit(run)(v, [jnp.asarray(x) for x in xs]))


@pytest.mark.parametrize("nd", [3, 2])
@pytest.mark.parametrize("train", [False, True])
def test_pose_head_matches_jax(nd, train):
    """Eval: the (B, 4 + nc + 4 nd, A) prediction (keypoints decoded in fp32,
    the visibility's sigmoid at nd 3), the raw maps and the raw keypoints
    (B, A, 4 nd) in JAX's anchor order; train: the raw maps and keypoints
    and the moved statistics; all within MOD_TOL."""
    v, xs, ((ref, (ref_maps, ref_kpt)), (rt_maps, rt_kpt), moved) = head_run(nd)
    pm = load_module(M.Pose(NC, HEAD_CH, kpt_shape=(4, nd)), v).train(train)
    assert pm.cv4[0][0].conv.out_channels == max(HEAD_CH[0] // 4, 4 * nd) and pm.cv4[0][2].bias is not None
    with torch.no_grad():
        out = pm([to_torch(x) for x in xs])
    if train:
        maps, kpt = out
        for f, rf in zip(maps, rt_maps):
            close(nhwc(f), rf, MOD_TOL)
        close(kpt.numpy(), rt_kpt, MOD_TOL)
        assert_stats_moved(pm, moved)
        return
    pred, (maps, kpt) = out
    assert pred.dtype == torch.float32 and pred.shape == ref.shape == (2, 4 + NC + 4 * nd, 84)
    close(pred.numpy(), ref, MOD_TOL)
    for f, rf in zip(maps, ref_maps):
        close(nhwc(f), rf, MOD_TOL)
    close(kpt.numpy(), ref_kpt, MOD_TOL)


# ---------------------------------------------------------------------------------------------------------------
# graphs


@functools.cache
def graph(cfg):
    """(JAX model, seeded JAX variables, the port model loaded strictly, JAX's
    eval output on GRAPH_X: (prediction, (maps, raw keypoints))), one jax.jit."""
    jm = JaxDetectionModel(cfg, nc=NC)
    v = seeded_variables(jm, 64, np.random.default_rng(1))
    pm = DetectionModel(cfg_nc(cfg), device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    out = jax.jit(lambda vv, x: jm.apply(vv, x, train=False))(v, jnp.asarray(GRAPH_X))
    return jm, v, pm, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("cfg,how", [(c, h) for c in GRAPHS for h in ("unfused", "port_fuse", "jax_folded_tree")
                                      if not (c != GRAPHS[0] and h == "jax_folded_tree")])
def test_graph_matches_jax(cfg, how):
    """Eval mode: the decoded prediction (boxes and keypoints within
    GRAPH_TOL of their largest magnitude, scores within GRAPH_TOL), the raw
    maps and the raw keypoints; a graph that names kpt_shape resolves it
    from the YAML, as JAX does. The port's fuse() and JAX's fuse_variables
    tree (read by fused_state_from_jax) equal each other."""
    _, v, pm, (ref, (ref_maps, ref_kpt)) = graph(cfg)
    assert pm.task == "pose" and pm.kpt_shape == (17, 3) and isinstance(pm.model[-1], M.Pose)
    if how == "port_fuse":
        pm = copy.deepcopy(pm).fuse()
        assert pm.is_fused
    elif how == "jax_folded_tree":
        own = copy.deepcopy(pm).fuse()
        pm = DetectionModel(cfg_nc(cfg), device="cpu").fuse()
        pm.load_state_dict(fused_state_from_jax(jax.tree.map(np.asarray, jax.jit(fuse_variables)(v))), strict=True)
        for k, t in own.state_dict().items():
            close(pm.state_dict()[k].numpy(), t.numpy(), 1e-6)
    with torch.no_grad():
        out, (maps, kpt) = pm(to_torch(GRAPH_X))
    assert out.shape == ref.shape == (2, 4 + NC + 51, 84) and out.dtype == torch.float32
    for a, b in ((0, 4), (4 + NC, 4 + NC + 51)):
        np.testing.assert_allclose(out[:, a:b].numpy(), ref[:, a:b], rtol=GRAPH_TOL,
                                   atol=GRAPH_TOL * np.abs(ref[:, a:b]).max())
    close(out[:, 4:4 + NC].numpy(), ref[:, 4:4 + NC], GRAPH_TOL)
    for f, rf in zip(maps, ref_maps):
        close(nhwc(f), rf, GRAPH_TOL)
    close(kpt.numpy(), ref_kpt, GRAPH_TOL)


@pytest.mark.parametrize("cfg", ["yolov8n-pose-p6.yaml", "yolo12n-pose.yaml"])
def test_names_and_shapes_equal_jax(cfg):
    """Every leaf of JAX's abstract variables (shape_init: no compile) names
    one port tensor of its shape and the port has no other (a strict load on
    the meta device)."""
    shapes = JaxDetectionModel(cfg).shape_init(imgsz=64)
    with torch.device("meta"):
        pm = DetectionModel(cfg, device="meta")
    state = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                             {k: shapes[k] for k in ("params", "batch_stats")}))
    pm.load_state_dict(state, strict=True, assign=True)
    assert pm.task == "pose" and pm.kpt_shape == (17, 3) and len(pm.strides) == (4 if "p6" in cfg else 3)
    assert all(tuple(state[k].shape) == tuple(t.shape) for k, t in pm.state_dict().items())


@pytest.mark.parametrize("cfg", GRAPHS)
def test_bridge_both_ways(cfg):
    """The Pose head's detect branches without JAX's `detect` scope, its
    keypoint branches as cv4_{i}_{k}; the state written back is JAX's tree,
    bit for bit."""
    _, v, pm, _ = graph(cfg)
    head = f"model.{len(pm.model) - 1}"
    names = set(pm.state_dict())
    assert {f"{head}.cv4.2.2.bias", f"{head}.cv4.0.1.conv.weight", f"{head}.cv2.0.2.bias",
            f"{head}.cv3.1.2.weight"} <= names
    assert not any(".detect." in n for n in names)
    assert "cv4_2_2" in v["params"][f"model_{len(pm.model) - 1}"]
    back = jax_variables_from_state(pm)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    want, got = flat({k: v[k] for k in ("params", "batch_stats")}), flat(back)
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)


def test_ckpt_and_pt_round_trips_and_ensemble_refuses_pose(tmp_path):
    """YOLO.save of yolov8n-pose as a JAX-format .ckpt and as a .pt, each
    read back by YOLO(path): task pose, the same state bit for bit; an
    ensemble with a pose member is refused, as in the JAX package."""
    y = YOLO(cfg_nc(GRAPHS[0]), device="cpu")
    y.model.load_state_dict(graph(GRAPHS[0])[2].state_dict())
    for name in ("m.ckpt", "m.pt"):
        y.save(str(tmp_path / name))
        back = YOLO(str(tmp_path / name), device="cpu")
        assert back.task == "pose" and back.model.kpt_shape == (17, 3)
        want = y.model.state_dict()
        assert all(torch.equal(t, want[k]) for k, t in back.model.state_dict().items())
    with pytest.raises(ValueError, match="pose member"):
        EnsembleModel([DetectionModel(cfg_nc("yolov8n.yaml"), device="cpu"), y.model])


def test_int8_gate_matches_jax():
    """quantize_model on yolov8n-pose calibrates the convs JAX's calibration
    pass records (jax.eval_shape of it: no compile), gives each Conv int8
    weights and leaves cv4's last 1x1 (a raw conv, as in JAX) float; the int8
    forward is finite."""
    jm, v, pm, (ref, _) = graph(GRAPHS[0])
    shapes = jax.eval_shape(lambda vv, x: jm.apply(vv, x, train=False, mutable=["calib"])[1]["calib"],
                            fuse_variables(v), jnp.zeros((1, 64, 64, 3), jnp.float32))
    want = to_port_calib(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    m = copy.deepcopy(pm).fuse()
    got = Q.calibrate(m, [FRAMES])
    assert got.keys() == want.keys() and all(got[k].keys() == want[k].keys() for k in want)
    head = f"model.{len(pm.model) - 1}"
    assert f"{head}.cv4.0.1" in got and f"{head}.cv4.0.2" not in got
    quantize_model(m, [FRAMES])
    assert all(c.w_int8 is not None for c in m.modules() if isinstance(c, M.Conv))
    assert all(not isinstance(br[2], M.Conv) and getattr(br[2], "w_int8", None) is None for br in m.model[-1].cv4)
    with torch.no_grad():
        out = m(to_torch(GRAPH_X))[0]
    assert out.shape == ref.shape and torch.isfinite(out).all()


# ---------------------------------------------------------------------------------------------------------------
# predict: NMS and the keypoints' scaling


def nms_rows(multi_label=False):
    """JAX's and the port's NMS on JAX's yolov8n-pose prediction (the
    keypoint columns after the class), at conf 0.001."""
    _, _, _, (ref, _) = graph(GRAPHS[0])
    kw = dict(conf_thres=0.001, iou_thres=0.7, max_det=30, nc=NC, multi_label=multi_label)
    return np.asarray(jax_nms(jnp.asarray(ref), **kw)), non_max_suppression(torch.from_numpy(ref.copy()), **kw)


@pytest.mark.parametrize("orig", [(48, 64), (64, 40), (150, 100)])
def test_predictor_keypoints_match_jax(orig):
    """The NMS rows carry JAX's keypoint columns bit for bit; on the same
    rows, the port predictor's keypoints (scale_coords on the rows' device)
    equal the JAX predictor's _postprocess_one bit for bit, (n, 17, 3) in
    the original frame's pixels, clipped to it."""
    jd, pd = nms_rows()
    np.testing.assert_array_equal(pd.numpy(), jd)
    imgsz = 64
    img0 = np.zeros((*orig, 3), np.uint8)
    r, _, (padw, _, padh, _) = letterbox_geometry(orig, imgsz)
    jp = JaxPredictor.__new__(JaxPredictor)
    jp.model = SimpleNamespace(task="pose", names={0: "a", 1: "b"}, specs=graph(GRAPHS[0])[0].specs)
    jp.args = SimpleNamespace()
    ref = jp._postprocess_one(jd[0].copy(), None, img0, "x", imgsz, r, padw, padh, {})
    p = DetectionPredictor(SimpleNamespace(kpt_shape=(17, 3)), get_cfg())
    got = p.keypoints(pd[:1], [(img0, "x")], imgsz)[0]
    assert got.shape == ref.keypoints.data.shape == (int((jd[0][:, 4] > 0).sum()), 17, 3) and len(got) > 0
    np.testing.assert_array_equal(got, ref.keypoints.data)
    assert got[..., 0].max() <= orig[1] and got[..., 1].max() <= orig[0] and got[..., :2].min() >= 0


def test_scale_coords_matches_jax():
    """ops/boxes.py scale_coords and clip_coords against JAX's, with and
    without ratio_pad, normalize and padding."""
    from improving_yolov8_cbam_swinblock_tpu.ops import boxes as JB
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import boxes as PB

    pts = np.random.default_rng(4).uniform(-20, 90, (5, 17, 3)).astype(np.float32)
    for kw in ({}, {"ratio_pad": ((0.5, 0.5), (3, 7))}, {"normalize": True}, {"padding": False}):
        want = np.asarray(JB.scale_coords((64, 64), jnp.asarray(pts), (100, 150), **kw))
        np.testing.assert_array_equal(PB.scale_coords((64, 64), torch.from_numpy(pts), (100, 150), **kw).numpy(), want)
    np.testing.assert_array_equal(PB.clip_coords(torch.from_numpy(pts[..., :2]), (40, 50)).numpy(),
                                  np.asarray(JB.clip_coords(jnp.asarray(pts[..., :2]), (40, 50))))


# ---------------------------------------------------------------------------------------------------------------
# metrics and the validator


def test_kpt_iou_matches_jax():
    rng = np.random.default_rng(6)
    for nk, nd in ((17, 3), (5, 3), (5, 2)):
        gt = np.concatenate([rng.uniform(0, 64, (6, nk, 2)), rng.integers(0, 3, (6, nk, 1))], -1).astype(np.float32)
        pred = rng.uniform(0, 64, (9, nk, nd)).astype(np.float32)
        area = rng.uniform(20, 900, 6).astype(np.float32)
        sigma = OKS_SIGMA if nk == 17 else np.ones(nk) / nk
        np.testing.assert_array_equal(kpt_iou_np(gt, pred, area, sigma), JME.kpt_iou_np(gt, pred, area, sigma))
    np.testing.assert_array_equal(OKS_SIGMA, JME.OKS_SIGMA)


def test_pose_validator_matches_jax():
    """The port's PoseValidator and JAX's on the same detections (with their
    keypoints) and batches (their forwards replaced by the same arrays):
    every metric within 1e-12, the box and pose Metric bundles equal."""
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import PoseValidator

    rng = np.random.default_rng(9)
    b, imgsz, md, nk = 3, 64, 20, 17
    batches, outs = [], []
    for k in range(2):
        cls = rng.integers(0, NC, (b, 6)).astype(np.float32)
        mask = (rng.random((b, 6)) < 0.7).astype(np.float32)
        boxes = np.concatenate([rng.uniform(0.25, 0.75, (b, 6, 2)), rng.uniform(0.1, 0.4, (b, 6, 2))], -1)
        kpts = np.concatenate([boxes[..., None, :2] + rng.normal(0, 0.05, (b, 6, nk, 2)),
                               rng.integers(0, 3, (b, 6, nk, 1))], -1).astype(np.float32)
        dets = np.zeros((b, md, 6 + nk * 3), np.float32)
        for i in range(b):
            n = int(rng.integers(0 if i == 0 and k == 0 else 3, md))
            gt = rng.integers(0, 6, n)
            xyxy = np.concatenate([boxes[i, gt, :2] - boxes[i, gt, 2:] / 2, boxes[i, gt, :2] + boxes[i, gt, 2:] / 2], 1)
            dets[i, :n, :4] = xyxy * imgsz + rng.normal(0, 1.5, (n, 4))
            dets[i, :n, 4] = np.sort(rng.uniform(0.01, 1, n))[::-1]
            dets[i, :n, 5] = np.where(rng.random(n) < 0.8, cls[i, gt], rng.integers(0, NC, n))
            pk = kpts[i, gt].copy()
            pk[..., :2] = pk[..., :2] * imgsz + rng.normal(0, 2, (n, nk, 2))
            pk[..., 2] = rng.uniform(0, 1, (n, nk))
            dets[i, :n, 6:] = pk.reshape(n, -1)
        batches.append({"img": np.zeros((b, imgsz, imgsz, 3), np.uint8), "cls": cls,
                        "bboxes": boxes.astype(np.float32), "mask": mask, "kpts": kpts})
        outs.append(dets)
    args = SimpleNamespace(imgsz=imgsz, max_det=md, verbose=False, plots=False, save_json=False, project=None,
                           name=None)
    model = SimpleNamespace(names={0: "a", 1: "b"}, nc=NC, eval=lambda: None, kpt_shape=(nk, 3))
    pv = PoseValidator(model, batches, args)
    it = iter(outs)
    pv.forward_nms = lambda img: next(it)
    got = pv()
    jv = JV.PoseValidator.__new__(JV.PoseValidator)
    jv.model, jv.args, jv.loader = model, args, batches
    jv.kpt_shape, jv.sigma = (nk, 3), JME.OKS_SIGMA
    jit = iter(outs)
    jv._forward_nms = lambda variables, img: next(jit)
    ref = jv(None)
    assert got.keys() == ref.keys() and got["mAP50(P)"] > 0 and got["mAP50-95"] == got["mAP50-95(P)"]
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-12), k
    assert pv.pose_m.box.mean_results() == pytest.approx(jv.pose_m.box.mean_results(), abs=1e-12)
    assert pv.box_m.box.mean_results() == pytest.approx(jv.box_m.box.mean_results(), abs=1e-12)


# ---------------------------------------------------------------------------------------------------------------
# Results, Keypoints and the drawings


def pose_results(nd=3):
    """The same detections and keypoints in a port and a JAX Results (a 96 x 128 frame)."""
    rng = np.random.default_rng(12 + nd)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    n = 4
    xy = rng.uniform(10, 80, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (n, 2)), rng.uniform(0.3, 1, (n, 1)),
                            rng.integers(0, NC, (n, 1))], 1).astype(np.float32)
    k = np.concatenate([rng.uniform(0, 96, (n, 17, 2)), rng.uniform(0, 1, (n, 17, nd - 2))], -1).astype(np.float32)
    got = Results(img, "x.png", {0: "a", 1: "b"}, boxes).update(keypoints=k)
    ref = JR.Results(img, "x.png", {0: "a", 1: "b"}, boxes)
    ref.keypoints = JR.Keypoints(k, img.shape[:2])
    return got, ref


@pytest.mark.parametrize("nd", [3, 2])
def test_keypoints_summary_and_save_txt_match_jax(nd, tmp_path):
    got, ref = pose_results(nd)
    g, r = got.keypoints, ref.keypoints
    assert isinstance(g, Keypoints) and len(g) == len(r) == 4 and g.shape == (4, 17, nd)
    for attr in ("data", "xy", "xyn"):
        np.testing.assert_array_equal(getattr(g, attr), getattr(r, attr))
    assert (g.conf is None) == (r.conf is None) and (g.conf is None or np.array_equal(g.conf, r.conf))
    gs, rs = got.summary(), ref.summary()
    for a, b, i in zip(gs, rs, range(4)):
        assert {k: a["keypoints"][k] for k in ("x", "y")} == b["keypoints"]
        assert ("visible" in a["keypoints"]) == (nd == 3)
        assert nd == 2 or a["keypoints"]["visible"] == g.conf[i].tolist()
        assert {k: v for k, v in a.items() if k != "keypoints"} == {k: v for k, v in b.items() if k != "keypoints"}
    assert json.loads(got.to_json()) == gs
    for save_conf in (False, True):
        got.save_txt(str(tmp_path / "p.txt"), save_conf=save_conf)
        ref.save_txt(str(tmp_path / "j.txt"), save_conf=save_conf)
        assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    sub = got[1:3]
    np.testing.assert_array_equal(sub.keypoints.data, ref[1:3].keypoints.data)
    assert got[2].keypoints.shape == (1, 17, nd)


def test_plot_and_annotator_kpts_match_jax():
    """Results.plot (the keypoint dots) and Annotator.kpts (the COCO skeleton
    at 17 points with conf_thres 0.25, the palette colours of 5 points of 2
    values) draw JAX's pixels."""
    got, ref = pose_results(3)
    np.testing.assert_array_equal(got.plot(), ref.plot())
    img = np.random.default_rng(3).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    for kp in (got.keypoints.data[0], got.keypoints.data[1][:5, :2]):
        a, b = Annotator(img.copy()), JaxAnnotator(img.copy())
        a.kpts(kp)
        b.kpts(kp)
        np.testing.assert_array_equal(a.result(), b.im)
    np.testing.assert_array_equal(a.kpt_color, b.kpt_color)
    np.testing.assert_array_equal(a.limb_color, b.limb_color)
    assert a.skeleton == b.skeleton


# ---------------------------------------------------------------------------------------------------------------
# YOLO: the program, track


# a small pose graph for the program: conv rows to strides 8, 16 and 32, and the Pose head with 5 points of 3
POSE_CFG = {"nc": 2, "kpt_shape": [5, 3], "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                                                       [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                                                       [-1, 1, "Conv", [64, 3, 2]]],
            "head": [[[2, 3, 4], 1, "Pose", ["nc", "kpt_shape"]]]}


def test_pose_program_equals_the_live_model(tmp_path):
    """A pose program (dynamic batch): one float32 (B, 4 + nc + 15, A)
    output equal to the live forward bit for bit; its sidecar says pose with
    kpt_shape; YOLO(path).predict gives the live model's boxes and keypoints
    at batches 1 and 3; nms=True is refused."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend

    y = YOLO(POSE_CFG, device="cpu").fuse()
    zero_class_priors(y.model)
    path = y.export(imgsz=64, dynamic=True, project=str(tmp_path))
    md = yaml.safe_load(open(f"{path}.yaml"))
    assert md["task"] == "pose" and md["kpt_shape"] == [5, 3] and md["batch"] == -1 and "keypoints" in md["layout"]
    served = YOLO(path, device="cpu")
    assert served.task == "pose" and served.model.kpt_shape == (5, 3)
    for b in (1, 3):
        img = np.random.default_rng(b).integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
        out = served.model.backend(img)
        assert out.shape == (b, 4 + 2 + 15, 84)
        np.testing.assert_array_equal(out, Backend(y.model)(img))
    with pytest.raises(ValueError, match="detect-task"):
        y.export(imgsz=64, nms=True, project=str(tmp_path))
    src = [np.random.default_rng(i).integers(0, 256, (48, 80, 3), dtype=np.uint8) for i in range(3)]
    for b in (1, 3):
        got = served.predict(src, conf=0.25, batch=b, verbose=False)
        ref = y.predict(src, imgsz=64, conf=0.25, batch=b, verbose=False)
        assert sum(len(r) for r in ref) > 0
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.boxes.data, r.boxes.data)
            np.testing.assert_array_equal(g.keypoints.data, r.keypoints.data)


def test_track_keeps_keypoints_in_the_detections_order():
    """YOLO.track on a pose model: each frame's Results keeps predict's
    keypoints, in the detections' order (the tracker re-orders the boxes
    only, as the JAX package's trackers/track.py does); augment=True is
    ignored for a pose model, as in the JAX predictor."""
    y = YOLO(POSE_CFG, device="cpu")
    zero_class_priors(y.model)
    frames = [np.random.default_rng(i).integers(0, 256, (64, 64, 3), dtype=np.uint8) for i in range(4)]
    plain = y.predict(frames, imgsz=64, conf=0.25, verbose=False)
    tta = y.predict(frames, imgsz=64, conf=0.25, augment=True, verbose=False)
    tracked = y.track(frames, tracker="bytetrack.yaml", imgsz=64, conf=0.25, verbose=False)
    assert sum(len(r) for r in plain) > 0
    for p, a, t in zip(plain, tta, tracked):
        np.testing.assert_array_equal(a.keypoints.data, p.keypoints.data)
        np.testing.assert_array_equal(t.keypoints.data, p.keypoints.data)
    assert any(len(t.track_ids) for t in tracked)


def write_pose_dataset(root, kpt_shape=(17, 3), n_train=4, n_val=4, flip_idx=None):
    """A tiny YOLO pose dataset (PNGs, 2 classes): 1 to 3 boxes per image,
    each with kpt_shape keypoints near it (visibility 0, 1 or 2 at nd 3)."""
    rng = np.random.default_rng(17)
    nk, nd = kpt_shape
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = (96, 128) if i % 2 else (128, 96)
            img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            lines = []
            for j in range(int(rng.integers(1, 4))):
                c, s = rng.uniform(0.3, 0.7, 2), rng.uniform(0.2, 0.35, 2)
                x1, y1 = ((c - s / 2) * [w, h]).astype(int)
                x2, y2 = ((c + s / 2) * [w, h]).astype(int)
                img[y1:y2, x1:x2] = (200, 100 + 50 * j, 60)
                k = np.clip(c + rng.uniform(-0.5, 0.5, (nk, 2)) * s, 0, 1)
                if nd == 3:
                    k = np.concatenate([k, rng.integers(0, 3, (nk, 1))], 1)
                lines.append(f"{j % 2} {c[0]:.5f} {c[1]:.5f} {s[0]:.5f} {s[1]:.5f} "
                             + " ".join(f"{v:.5f}" for v in k.reshape(-1)))
            cv2.imwrite(str(root / "images" / split / f"{i}.png"), img)
            (root / "labels" / split / f"{i}.txt").write_text("\n".join(lines) + "\n")
    data = {"path": str(root), "train": "images/train", "val": "images/val", "nc": NC, "names": {"0": "a", "1": "b"},
            "kpt_shape": list(kpt_shape)}
    if flip_idx is not None:
        data["flip_idx"] = list(flip_idx)
    (root / "data.yaml").write_text(json.dumps(data))
    return root / "data.yaml"
