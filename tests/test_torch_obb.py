"""Oriented boxes (OBB) in the port vs the JAX package, on the same weights and inputs.

Rotated ops (ops/rotated.py) against JAX's ops/rotated.py on the same
seeded boxes: probiou with and without its CIoU term, the corners,
dist2rbox, regularize_rboxes, the rotated candidate gate (equal), nms_rotated
(the same indices) and xyxyxyxy2xywhr, within ROT_TOL (the same fp32 math;
XLA's and torch's cos, sin, log and exp differ by an ulp), each JAX op
under one jax.jit but probiou, run op by op as nms_rotated (a host
function in JAX) is.

Head and graphs: the OBB head at module level (nc 2, the v8 cls branch) in
eval mode (the (B, 4 + nc + 1, A) prediction: rotated xywh decoded with the
angle, scores, the angle; the raw maps and the angles) and in train mode
(raw maps, angles, the moved BatchNorm statistics), within MOD_TOL;
yolov8n-obb, yolo11n-obb and yolo12n-obb at 64 px, nc 2, on seeded JAX
variables bridged into the port, eval (unfused, BN-folded by the port and,
for yolov8n-obb, from JAX's BN-folded tree) and train mode (raw maps, angles,
moved statistics), within GRAPH_TOL of the largest magnitude, one jax.jit
per graph (compiled at XLA's optimization level 0, QUICK); yolov8n-obb's
and yolov8s-obb's parameter counts against JAX's (its abstract trace, the
port built on the meta device); the weight bridge
both ways, bit for bit, and the .ckpt and .pt round trips; an ensemble
refuses an OBB member.

Post-processing: the rotated NMS rows equal JAX's non_max_suppression(
rotated=True) on the same prediction (multi-label and not); the
predictor's oriented boxes (letterbox undone, regularize_rboxes, on the
rows' device) equal the JAX predictor's _postprocess_one bit for bit, and
its enclosing boxes too. Results: OBB's xywhr, corners and enclosing boxes,
indexing, verbose, summary and save_txt equal JAX's; Annotator.box_label
with rotated=True and output_to_rotated_target equal JAX's. int8:
quantizing yolov8n-obb calibrates the convs JAX's calibration pass records
and leaves each cv4.i.2 float. An OBB program through YOLO(path) equals the
live model at batches 1 and 3; YOLO.track keeps the oriented boxes in the
detections' order and augment=True is ignored, as in the JAX package.
"""

import copy
import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.engine import results as JR
from improving_yolov8_cbam_swinblock_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from improving_yolov8_cbam_swinblock_tpu.nn import heads as JH
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.ops import rotated as JROT
from improving_yolov8_cbam_swinblock_tpu.ops.nms import non_max_suppression as jax_nms
from improving_yolov8_cbam_swinblock_tpu.utils import plotting as JP
from improving_yolov8_cbam_swinblock_tpu.utils.fuse import fuse_variables
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, EnsembleModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg
from improving_yolov8_cbam_swinblock_tpu_torch.data.augment import letterbox_geometry
from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import DetectionPredictor
from improving_yolov8_cbam_swinblock_tpu_torch.engine.results import OBB, Results
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
from improving_yolov8_cbam_swinblock_tpu_torch.ops import quant as Q
from improving_yolov8_cbam_swinblock_tpu_torch.ops import rotated as PROT
from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import non_max_suppression
from improving_yolov8_cbam_swinblock_tpu_torch.utils import plotting as PP
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import (fused_state_from_jax,
                                                                         jax_variables_from_state,
                                                                         state_dict_from_jax)
from tests.int8_parity import to_port_calib
from tests.seeded_scores import zero_class_priors
from tests.test_torch_model import seeded_variables
from tests.test_torch_v10 import MOD_TOL, assert_stats_moved, load_module
from tests.test_torch_yolo11 import close, nhwc, seeded_module, to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
GRAPH_TOL = 2e-3
# the graphs' JAX forward compiled at XLA's backend optimization level 0: a third of the compile time, its convs
# summed in another order (6.8e-5 at most on yolo12n-obb's outputs, far inside GRAPH_TOL)
QUICK = {"xla_backend_optimization_level": 0}
ROT_TOL = 1e-5
NC = 2
GRAPHS = ("yolov8n-obb.yaml", "yolo11n-obb.yaml", "yolo12n-obb.yaml")
FRAMES = np.random.default_rng(66).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)  # RGB
GRAPH_X = FRAMES.astype(np.float32) / 255.0
HEAD_CH = (16, 32, 64)  # OBB's input channels at module level; maps 8x8, 4x4, 2x2 (a 64 px input)


def cfg_nc(cfg, nc=NC):
    d = yaml_model_load(cfg)
    d["nc"] = nc
    return d


def rboxes(rng, n, lo=2.0, hi=40.0):
    """n seeded xywhr boxes: centres in [0, 64), sides in [lo, hi), angles in [-pi/4, 3 pi/4)."""
    return np.concatenate([rng.uniform(0, 64, (n, 2)), rng.uniform(lo, hi, (n, 2)),
                           rng.uniform(-np.pi / 4, 3 * np.pi / 4, (n, 1))], 1).astype(np.float32)


# ---------------------------------------------------------------------------------------------------------------
# rotated ops


def _op_case(name):
    """(JAX's value, the port's value) of one rotated op on seeded inputs."""
    rng = np.random.default_rng(3)
    a, b = rboxes(rng, 40), rboxes(rng, 40)
    b[:8] = a[:8]  # identical pairs
    b[8:12, 2:4] = a[8:12, 2:4] * 1e-3  # thin boxes: near-zero determinants
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if name in ("probiou", "probiou_ciou"):
        ci = name == "probiou_ciou"
        # op by op: XLA's fused exp rounds otherwise near 0, where identical boxes sit and the sqrt of
        # 1 - exp(-eps) turns an ulp of it into 2e-5 of the IoU
        return (JROT.probiou(jnp.asarray(a)[:, None], jnp.asarray(b)[None], CIoU=ci),
                PROT.probiou(ta[:, None], tb[None], CIoU=ci))
    if name == "corners":
        return jax.jit(JROT.xywhr2xyxyxyxy)(a), PROT.xywhr2xyxyxyxy(ta)
    if name == "dist2rbox":
        d, ang, anc = rng.uniform(0, 15, (2, 30, 4)), rng.uniform(-0.8, 2.4, (2, 30, 1)), rng.uniform(0, 8, (30, 2))
        d, ang, anc = (x.astype(np.float32) for x in (d, ang, anc))
        return (jax.jit(JROT.dist2rbox)(d, ang, anc[None]),
                PROT.dist2rbox(torch.from_numpy(d), torch.from_numpy(ang), torch.from_numpy(anc)[None]))
    if name == "regularize":
        a[:10, 3] = a[:10, 2]  # w == h: the turn by pi / 2
        a[10:20, 4] = rng.uniform(-3, 6, 10)
        return jax.jit(JROT.regularize_rboxes)(a), PROT.regularize_rboxes(ta)
    if name == "candidates":
        gt = rboxes(rng, 12).reshape(2, 6, 5)
        gt[0, 0] = [20, 20, 16, 8, 0]  # axis-aligned: anchors on its edges
        gt[0, 1] = [32, 32, 16, 16, np.pi / 2]
        anc = (np.stack(np.meshgrid(np.arange(16), np.arange(16)), -1).reshape(-1, 2) * 4 + 2).astype(np.float32)
        return (jax.jit(JROT.select_candidates_in_rotated_gts)(anc, gt),
                PROT.select_candidates_in_rotated_gts(torch.from_numpy(anc), torch.from_numpy(gt)))
    if name == "nms_rotated":
        c = rboxes(rng, 6)
        boxes = np.repeat(c, 8, 0) + np.concatenate([rng.normal(0, 2, (48, 4)), rng.normal(0, 0.2, (48, 1))], 1)
        boxes[:, 2:4] = np.abs(boxes[:, 2:4]) + 1
        scores = rng.uniform(0, 1, 48).astype(np.float32)
        scores[5] = scores[9]  # a tie: the lower index first
        return (JROT.nms_rotated(boxes.astype(np.float32), scores, 0.3),
                PROT.nms_rotated(torch.from_numpy(boxes.astype(np.float32)), torch.from_numpy(scores), 0.3))
    if name == "xyxyxyxy2xywhr":
        pts = np.array(jax.jit(JROT.xywhr2xyxyxyxy)(a))
        return jax.jit(JROT.xyxyxyxy2xywhr)(pts), PROT.xyxyxyxy2xywhr(torch.from_numpy(pts))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["probiou", "probiou_ciou", "corners", "dist2rbox", "regularize", "candidates",
                                  "nms_rotated", "xyxyxyxy2xywhr"])
def test_rotated_ops_match_jax(name):
    """Each op within ROT_TOL of JAX's (of the largest magnitude); the gate
    and the NMS indices equal."""
    ref, got = _op_case(name)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape and (got.dtype == ref.dtype or name == "nms_rotated")  # torch's int64 indices
    if name in ("candidates", "nms_rotated"):
        np.testing.assert_array_equal(got, ref)
        assert got.any() if name == "candidates" else 0 < len(got) < 48
    else:
        close(got, ref, ROT_TOL)


# ---------------------------------------------------------------------------------------------------------------
# the head


@functools.cache
def head_run():
    """OBB (nc 2) at module level: seeded variables, inputs, its eval output,
    train output and moved batch_stats, one jax.jit."""
    rng = np.random.default_rng(21)
    xs = [rng.normal(0, 1, (2, 8 // 2**i, 8 // 2**i, c)).astype(np.float32) for i, c in enumerate(HEAD_CH)]
    jm = JH.OBB(nc=NC, ne=1, ch=HEAD_CH)
    v = seeded_module(jm, [jnp.asarray(x) for x in xs], rng)

    def run(vv, xx):
        train, moved = jm.apply(vv, xx, train=True, mutable=["batch_stats"])
        return jm.apply(vv, xx, train=False), train, moved["batch_stats"]

    return v, xs, jax.tree.map(np.asarray, jax.jit(run)(v, [jnp.asarray(x) for x in xs]))


@pytest.mark.parametrize("train", [False, True])
def test_obb_head_matches_jax(train):
    """Eval: the (B, 4 + nc + 1, A) prediction (rotated boxes decoded with
    the fp32 angle), the raw maps and the angles (B, A, 1) in JAX's anchor
    order; train: the raw maps, the angles and the moved statistics; all
    within MOD_TOL."""
    v, xs, ((ref, (ref_maps, ref_ang)), (rt_maps, rt_ang), moved) = head_run()
    pm = load_module(M.OBB(NC, HEAD_CH), v).train(train)
    assert pm.cv4[0][0].conv.out_channels == max(HEAD_CH[0] // 4, 1) and pm.cv4[0][2].out_channels == 1
    with torch.no_grad():
        out = pm([to_torch(x) for x in xs])
    if train:
        maps, ang = out
        for f, rf in zip(maps, rt_maps):
            close(nhwc(f), rf, MOD_TOL)
        close(ang.numpy(), rt_ang, MOD_TOL)
        assert_stats_moved(pm, moved)
        return
    pred, (maps, ang) = out
    assert pred.dtype == ang.dtype == torch.float32 and pred.shape == ref.shape == (2, 4 + NC + 1, 84)
    close(pred.numpy(), ref, MOD_TOL)
    for f, rf in zip(maps, ref_maps):
        close(nhwc(f), rf, MOD_TOL)
    close(ang.numpy(), ref_ang, MOD_TOL)
    assert (ang >= -np.pi / 4).all() and (ang < 3 * np.pi / 4).all()


# ---------------------------------------------------------------------------------------------------------------
# graphs


@functools.cache
def graph(cfg):
    """(JAX model, seeded JAX variables, the port model loaded strictly, JAX's
    eval output on GRAPH_X, its train output and moved batch_stats), one jax.jit."""
    jm = JaxDetectionModel(cfg, nc=NC)
    v = seeded_variables(jm, 64, np.random.default_rng(1))
    pm = DetectionModel(cfg_nc(cfg), device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)

    def run(vv, x):
        train, moved = jm.apply(vv, x, train=True, mutable=["batch_stats"])
        return jm.apply(vv, x, train=False), train, moved["batch_stats"]

    x = jnp.asarray(GRAPH_X)
    return jm, v, pm, jax.tree.map(np.asarray, jax.jit(run).lower(v, x).compile(compiler_options=QUICK)(v, x))


def _graph_cases():
    return [(c, h) for c in GRAPHS for h in ("unfused", "port_fuse", "jax_folded_tree", "train")
            if not (c != GRAPHS[0] and h == "jax_folded_tree")]


@pytest.mark.parametrize("cfg,how", _graph_cases())
def test_graph_matches_jax(cfg, how):
    """Eval: the rotated boxes' centre and size within GRAPH_TOL of their
    largest magnitude, the scores and the angles within GRAPH_TOL, the raw
    maps too; the port's fuse() and JAX's fuse_variables tree (read by
    fused_state_from_jax) equal each other. Train: the raw maps, the angles
    and the moved statistics."""
    _, v, pm, ((ref, (ref_maps, ref_ang)), (rt_maps, rt_ang), moved) = graph(cfg)
    assert pm.task == "obb" and isinstance(pm.model[-1], M.OBB) and pm.model[-1].ne == 1
    if how == "train":
        tm = copy.deepcopy(pm).train()
        with torch.no_grad():
            maps, ang = tm(to_torch(GRAPH_X))
        for f, rf in zip(maps, rt_maps):
            close(nhwc(f), rf, GRAPH_TOL)
        close(ang.numpy(), rt_ang, GRAPH_TOL)
        want = state_dict_from_jax({"batch_stats": moved})
        got = tm.state_dict()
        for k in (k for k in want if k.endswith(("running_mean", "running_var"))):
            close(got[k].numpy(), want[k].numpy(), GRAPH_TOL)
        return
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
        out, (maps, ang) = pm(to_torch(GRAPH_X))
    assert out.shape == ref.shape == (2, 4 + NC + 1, 84) and out.dtype == torch.float32
    np.testing.assert_allclose(out[:, :4].numpy(), ref[:, :4], rtol=GRAPH_TOL,
                               atol=GRAPH_TOL * np.abs(ref[:, :4]).max())
    close(out[:, 4:].numpy(), ref[:, 4:], GRAPH_TOL)
    for f, rf in zip(maps, ref_maps):
        close(nhwc(f), rf, GRAPH_TOL)
    close(ang.numpy(), ref_ang, GRAPH_TOL)


@pytest.mark.parametrize("cfg", ["yolov8n-obb.yaml", "yolov8s-obb.yaml"])
def test_parameter_count_equals_jax(cfg):
    """nc 15 (DOTAv1's): the port built on the meta device holds as many
    parameters as JAX's abstract variables (shape_init: no compile), each
    leaf naming one port tensor of its shape."""
    shapes = JaxDetectionModel(cfg, nc=15).shape_init(imgsz=64)
    with torch.device("meta"):
        pm = DetectionModel(cfg_nc(cfg, 15), device="meta")
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_jax
    state = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                             {k: shapes[k] for k in ("params", "batch_stats")}))
    pm.load_state_dict(state, strict=True, assign=True)
    assert pm.task == "obb" and pm.nc == 15


@pytest.mark.parametrize("cfg", GRAPHS[:2])
def test_bridge_both_ways(cfg):
    """The OBB head's detect branches without JAX's `detect` scope, its
    angle branches as cv4_{i}_{k}; the state written back is JAX's tree,
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


def test_ckpt_and_pt_round_trips_and_ensemble_refuses_obb(tmp_path):
    """YOLO.save of yolov8n-obb as a JAX-format .ckpt and as a .pt, each
    read back by YOLO(path): task obb, the same state bit for bit; an
    ensemble with an OBB member is refused, as in the JAX package."""
    y = YOLO(cfg_nc(GRAPHS[0]), device="cpu")
    y.model.load_state_dict(graph(GRAPHS[0])[2].state_dict())
    for name in ("m.ckpt", "m.pt"):
        y.save(str(tmp_path / name))
        back = YOLO(str(tmp_path / name), device="cpu")
        assert back.task == "obb"
        want = y.model.state_dict()
        assert all(torch.equal(t, want[k]) for k, t in back.model.state_dict().items())
    with pytest.raises(ValueError, match="obb member"):
        EnsembleModel([DetectionModel(cfg_nc("yolov8n.yaml"), device="cpu"), y.model])


def test_int8_gate_matches_jax():
    """quantize_model on yolov8n-obb calibrates the convs JAX's calibration
    pass records (jax.eval_shape of it: no compile), gives each Conv int8
    weights and leaves cv4's last 1x1 (a raw conv, as in JAX) float; the int8
    forward is finite."""
    jm, v, pm, ((ref, _), _, _) = graph(GRAPHS[0])
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
# predict: the rotated NMS and the boxes' scaling


def synthetic_prediction(seed=5, a=240):
    """(2, 4 + nc + 1, a): rotated boxes around 8 centres an image (so that
    probiou suppresses), class scores, angles in [-pi/4, 3 pi/4)."""
    rng = np.random.default_rng(seed)
    c = np.repeat(rng.uniform(8, 56, (2, 8, 2)), a // 8, 1) + rng.normal(0, 1.5, (2, a, 2))
    wh = np.repeat(rng.uniform(4, 30, (2, 8, 2)), a // 8, 1) * rng.uniform(0.8, 1.25, (2, a, 2))
    ang = np.repeat(rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 8, 1)), a // 8, 1) + rng.normal(0, 0.1, (2, a, 1))
    scores = rng.uniform(0, 1, (2, a, NC)) ** 3
    return np.concatenate([c, wh, scores, ang], -1).transpose(0, 2, 1).astype(np.float32)


@pytest.mark.parametrize("source", ["synthetic", "graph"])
@pytest.mark.parametrize("multi_label", [False, True])
def test_rotated_nms_rows_match_jax(source, multi_label):
    """The port's rotated NMS equals JAX's non_max_suppression(rotated=True)
    on the same prediction: rows x, y, w, h, conf, cls, angle, bit for bit."""
    pred = synthetic_prediction() if source == "synthetic" else graph(GRAPHS[0])[3][0][0]
    kw = dict(conf_thres=1e-5 if source == "graph" else 0.05, iou_thres=0.4, max_det=40, nc=NC,  # priors: ~1e-4
              multi_label=multi_label)
    ref = np.asarray(jax_nms(jnp.asarray(pred), rotated=True, **kw))
    got = non_max_suppression(torch.from_numpy(pred.copy()), rotated=True, **kw).numpy()
    assert got.shape == ref.shape == (2, 40, 7)
    np.testing.assert_array_equal(got, ref)
    kept = (got[..., 4] > 0).sum(1)  # the seeded graph's boxes are wide: its first pick suppresses the rest
    assert (kept > 4).all() if source == "synthetic" else (kept > 0).all()


@pytest.mark.parametrize("orig", [(48, 64), (64, 40), (150, 100)])
def test_predictor_obb_matches_jax(orig):
    """On the same rotated NMS rows, the port predictor's oriented boxes
    (the letterbox's integer pad and gain undone, regularize_rboxes, on the
    rows' device) equal the JAX predictor's _postprocess_one bit for bit:
    Results.obb (n, 7) and the enclosing Results.boxes (n, 6), unclipped."""
    pred = synthetic_prediction(seed=7)
    dets = non_max_suppression(torch.from_numpy(pred), conf_thres=0.05, iou_thres=0.4, max_det=30, nc=NC,
                               rotated=True)
    imgsz = 64
    img0 = np.zeros((*orig, 3), np.uint8)
    r, _, (padw, _, padh, _) = letterbox_geometry(orig, imgsz)
    jp = JaxPredictor.__new__(JaxPredictor)
    jp.model = SimpleNamespace(task="obb", names={0: "a", 1: "b"})
    jp.args = SimpleNamespace()
    ref = jp._postprocess_one(dets[0].numpy().copy(), None, img0, "x", imgsz, r, padw, padh, {})
    p = DetectionPredictor(SimpleNamespace(task="obb"), get_cfg())
    got = p.rotated_boxes(dets[:1], [(img0, "x")], imgsz)[0]
    assert got.shape == ref.obb.data.shape == (int((dets[0][:, 4] > 0).sum()), 7) and len(got) > 0
    np.testing.assert_array_equal(got, ref.obb.data)
    res = Results(img0, "x", {0: "a", 1: "b"}).update(obb=got)
    res.update(boxes=np.concatenate([res.obb.xyxy, got[:, 5:7]], 1))
    np.testing.assert_array_equal(res.boxes.data, ref.boxes.data)
    assert (got[:, 2] >= got[:, 3]).all() and (got[:, 4] >= 0).all() and (got[:, 4] < np.pi).all()


# ---------------------------------------------------------------------------------------------------------------
# Results, OBB and the drawings


def obb_results():
    """The same oriented boxes in a port and a JAX Results (a 96 x 128 frame)."""
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    n = 5
    rb = np.concatenate([rng.uniform(10, 90, (n, 2)), rng.uniform(5, 40, (n, 2)), rng.uniform(0, np.pi, (n, 1)),
                         rng.uniform(0.3, 1, (n, 1)), np.array([[0], [1], [1], [0], [1]])], 1).astype(np.float32)
    got = Results(img, "x.png", {0: "a", 1: "b"}).update(obb=rb)
    ref = JR.Results(img, "x.png", {0: "a", 1: "b"})
    ref.obb = JR.OBB(rb, img.shape[:2])
    for r in (got, ref):
        r.update(boxes=np.concatenate([r.obb.xyxy, rb[:, 5:7]], 1))
    return got, ref


def test_obb_container_indexing_verbose_and_save_txt_match_jax(tmp_path):
    got, ref = obb_results()
    g, r = got.obb, ref.obb
    assert isinstance(g, OBB) and len(g) == len(r) == 5 and not g.is_track and g.id is None
    for attr in ("data", "xywhr", "conf", "cls", "xyxyxyxy", "xyxy"):
        np.testing.assert_array_equal(getattr(g, attr), getattr(r, attr))
    tracked = OBB(np.insert(g.data, 5, np.arange(5), 1), got.orig_shape)
    rt = JR.OBB(np.insert(r.data, 5, np.arange(5), 1), ref.orig_shape)
    assert tracked.is_track and np.array_equal(tracked.id, rt.id) and np.array_equal(tracked.conf, rt.conf)
    assert got.verbose() == ref.verbose() == "2 as, 3 bs, "
    for idx in (slice(1, 3), 2, [0, 4]):
        np.testing.assert_array_equal(got[idx].obb.data, ref[idx].obb.data)
    assert got.summary() == ref.summary()
    for save_conf in (False, True):
        got.save_txt(str(tmp_path / "p.txt"), save_conf=save_conf)
        ref.save_txt(str(tmp_path / "j.txt"), save_conf=save_conf)
        assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert len((tmp_path / "p.txt").read_text().splitlines()[0].split()) == 10
    empty = Results(got.orig_img, "x", got.names)
    assert empty.obb is None and empty.verbose() == "(no detections), "


def test_rotated_box_label_and_rotated_target_match_jax():
    """Annotator.box_label(rotated=True) draws JAX's pixels (the polyline and
    the label at the first corner), the axis-aligned path too; and
    output_to_rotated_target equals JAX's."""
    got, _ = obb_results()
    img = np.random.default_rng(3).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    a, b = PP.Annotator(img.copy()), JP.Annotator(img.copy())
    for i, pts in enumerate(got.obb.xyxyxyxy):
        a.box_label(pts.reshape(-1), f"c{i}", (0, 255, 0), rotated=True)
        b.box_label(pts.reshape(-1), f"c{i}", (0, 255, 0), rotated=True)
    a.box_label([5, 6, 40, 50], "ax", (200, 10, 10))
    b.box_label([5, 6, 40, 50], "ax", (200, 10, 10))
    np.testing.assert_array_equal(a.result(), b.im)
    out = non_max_suppression(torch.from_numpy(synthetic_prediction()), conf_thres=0.05, max_det=20, nc=NC,
                              rotated=True).numpy()
    for x, y in zip(PP.output_to_rotated_target(out, max_det=15), JP.output_to_rotated_target(out, max_det=15)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------------------------------------------
# YOLO: the program, track


# a small OBB graph for the program and track: conv rows to strides 8, 16 and 32, and the OBB head
OBB_CFG = {"nc": 2, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                                 [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                                 [-1, 1, "Conv", [64, 3, 2]]],
           "head": [[[2, 3, 4], 1, "OBB", ["nc", 1]]]}


def test_obb_program_equals_the_live_model(tmp_path):
    """An OBB program (dynamic batch): one float32 (B, 4 + nc + 1, A) output
    equal to the live forward bit for bit; its sidecar says obb; YOLO(path)
    .predict gives the live model's oriented and enclosing boxes at batches
    1 and 3; nms=True is refused."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend

    y = YOLO(OBB_CFG, device="cpu").fuse()
    zero_class_priors(y.model)
    path = y.export(imgsz=64, dynamic=True, project=str(tmp_path))
    md = yaml.safe_load(open(f"{path}.yaml"))
    assert md["task"] == "obb" and md["batch"] == -1 and "angle" in md["layout"]
    served = YOLO(path, device="cpu")
    assert served.task == "obb"
    for b in (1, 3):
        img = np.random.default_rng(b).integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
        out = served.model.backend(img)
        assert out.shape == (b, 4 + 2 + 1, 84)
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
            np.testing.assert_array_equal(g.obb.data, r.obb.data)


def test_track_keeps_obb_in_the_detections_order():
    """YOLO.track on an OBB model: each frame's Results keeps predict's
    oriented boxes, in the detections' order (the tracker re-orders the
    enclosing boxes only, as the JAX package's trackers/track.py does);
    augment=True is ignored for an OBB model, as in the JAX predictor."""
    y = YOLO(OBB_CFG, device="cpu")
    zero_class_priors(y.model)
    frames = [np.random.default_rng(i).integers(0, 256, (64, 64, 3), dtype=np.uint8) for i in range(4)]
    plain = y.predict(frames, imgsz=64, conf=0.25, verbose=False)
    tta = y.predict(frames, imgsz=64, conf=0.25, augment=True, verbose=False)
    tracked = y.track(frames, tracker="bytetrack.yaml", imgsz=64, conf=0.25, verbose=False)
    assert sum(len(r) for r in plain) > 0
    for p, a, t in zip(plain, tta, tracked):
        np.testing.assert_array_equal(a.obb.data, p.obb.data)
        np.testing.assert_array_equal(t.obb.data, p.obb.data)
    assert any(len(t.track_ids) for t in tracked)


def write_obb_dataset(root, n_train=4, n_val=4, nc=NC):
    """A tiny YOLO-OBB dataset (PNGs): 1 to 3 filled rotated rectangles per
    image, each labelled by its 4 corners normalised (clipped to the image)."""
    import cv2

    rng = np.random.default_rng(18)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = (96, 128) if i % 2 else (128, 96)
            img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            lines = []
            for j in range(int(rng.integers(1, 4))):
                c, s, a = rng.uniform(0.3, 0.7, 2) * [w, h], rng.uniform(0.15, 0.4, 2) * [w, h], rng.uniform(0, np.pi)
                rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
                q = (np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * s / 2) @ rot.T + c
                cv2.fillPoly(img, [np.round(q).astype(np.int32)], (200, 100 + 50 * j, 60))
                lines.append(f"{j % nc} " + " ".join(f"{v:.5f}" for v in np.clip(q / [w, h], 0, 1).reshape(-1)))
            cv2.imwrite(str(root / "images" / split / f"{i}.png"), img)
            (root / "labels" / split / f"{i}.txt").write_text("\n".join(lines) + "\n")
    data = {"path": str(root), "train": "images/train", "val": "images/val", "nc": nc,
            "names": {str(k): f"c{k}" for k in range(nc)}}
    (root / "data.yaml").write_text(json.dumps(data))
    return root / "data.yaml"
