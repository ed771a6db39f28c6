"""Instance segmentation in the port vs the JAX package, on the same weights and inputs.

Heads and graphs: the bias priors of a seeded port model (v8 Detect, YOLO11
Detect, both v10Detect branches, Segment) equal JAX's flax init exactly;
yolov8n-seg (Segment, v8 cls branch) and yolo11n-seg (legacy=False) at
64 px with nc=2, on seeded JAX variables bridged into the port: the decoded
(B, 4 + nc + nm, A) prediction, the raw maps, the mask coefficients and the
prototypes in eval mode (unfused, BN-folded by the port, and JAX's folded
tree, for yolov8n-seg), within 2e-3 (GRAPH_TOL, of the largest magnitude:
~60 fp32 layers summed in another order); Proto and Segment at module level
in eval and train mode, with the moved BatchNorm statistics, within 1e-5; the six packaged seg YAMLs' parameter counts; the weight bridge both
ways, bit for bit, and the .ckpt round trip. One jax.jit per graph and one
for both heads. int8 (tests/int8_parity.py): yolov8n-seg calibrated and
quantized by both packages on the same batch (Proto's transposed conv and
cv4's last 1x1 float), the calibration, the quant state and the int8
graph's prediction, coefficients and prototypes held to JAX's.

Post-processing: NMS carrying the coefficients (single- and multi-label)
bit for bit; process_mask within 1e-6 and process_mask_native on all but
0.5 % of pixels (their resizes sum in another order); fill_poly bit for bit
against cv2.fillPoly; the predictor's masks against the JAX predictor's cv2
path on the same prototypes and coefficients (all but 0.5 % of pixels:
cv2.resize rounds its weights to fixed point); SegmentationValidator's
metrics equal JAX's on the same detections and masks (1e-12). End to end
on the CPU: YOLO("yolov8n-seg.yaml") trains 2 micro-steps on a tiny
polygon dataset, validates and predicts masks.
"""

import copy
import functools
import json
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.engine import validator as JV
from improving_yolov8_cbam_swinblock_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from improving_yolov8_cbam_swinblock_tpu.nn import heads as JH
from improving_yolov8_cbam_swinblock_tpu.nn import modules as JMo
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.ops import boxes as JB
from improving_yolov8_cbam_swinblock_tpu.ops.nms import non_max_suppression as jax_nms
from improving_yolov8_cbam_swinblock_tpu.utils.fuse import fuse_variables
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, EnsembleModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.data.augment import letterbox_geometry
from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import native_masks
from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import SegmentationValidator
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
from improving_yolov8_cbam_swinblock_tpu_torch.ops import boxes as PB
from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import MAX_NMS, non_max_suppression
from improving_yolov8_cbam_swinblock_tpu_torch.utils import settings as PS
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import (fused_state_from_jax,
                                                                         jax_variables_from_state,
                                                                         state_dict_from_jax)
from improving_yolov8_cbam_swinblock_tpu_torch.utils.patches import fill_poly
from tests.seeded_scores import zero_class_priors
from tests.int8_parity import (assert_calibration_close, assert_int8_geometry, assert_out_close,
                               assert_quant_state_close, int8_with_jax_state, jax_int8, port_int8)
from tests.test_torch_model import seeded_variables
from tests.test_torch_predict import random_prediction
from tests.test_torch_v10 import MOD_TOL, assert_stats_moved, load_module
from tests.test_torch_yolo11 import close, nhwc, seeded_module, to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
GRAPH_TOL = 2e-3
# the graphs' JAX forward compiled at XLA's backend optimization level 0: a shorter compile, its convs summed in
# another order (far inside GRAPH_TOL, as tests/test_torch_obb.py measured)
QUICK = {"xla_backend_optimization_level": 0}
NC = 2
GRAPHS = ("yolov8n-seg.yaml", "yolo11n-seg.yaml")
# JAX's parameter counts at nc=80 (its shape_init), held as numbers so that these tests trace no larger graph
JAX_PARAMS = {"yolov8n-seg.yaml": 3_409_952, "yolov8n-seg-p6.yaml": 5_302_800, "yolo11n-seg.yaml": 2_876_832,
              "yolo12n-seg.yaml": 2_855_040, "yolov9c-seg.yaml": 27_897_104, "yolov9e-seg.yaml": 60_512_784}
FRAMES = np.random.default_rng(64).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)  # RGB
GRAPH_X = FRAMES.astype(np.float32) / 255.0


def cfg_nc(cfg, nc=NC):
    d = yaml_model_load(cfg)
    d["nc"] = nc
    return d


# ---------------------------------------------------------------------------------------------------------------
# bias priors


def test_bias_priors_equal_jax_flax_init():
    """A seeded port model's last box and class biases (and a Segment head's
    coefficient biases) equal those JAX's flax init gives the same head:
    yolov8n (v8 Detect), yolo11n (YOLO11 Detect), yolov10n (both branches)
    and yolov8n-seg. One jax.jit of the four inits, only the biases returned."""
    graphs = {"v8": "yolov8n.yaml", "11": "yolo11n.yaml", "v10": "yolov10n.yaml", "seg": "yolov8n-seg.yaml"}
    heads = {k: DetectionModel(cfg, device="cpu").model[-1] for k, cfg in graphs.items()}
    ch = (64, 128, 256)
    assert all(tuple(h.cv2[i][0].conv.in_channels for i in range(3)) == ch for h in heads.values())
    jax_heads = {"v8": JMo.Detect(nc=80, ch=ch), "11": JMo.Detect(nc=80, ch=ch, legacy=False),
                 "v10": JH.v10Detect(nc=80, ch=ch), "seg": JH.Segment(nc=80, nm=32, npr=64, ch=ch)}
    xs = [jnp.zeros((1, 8 // 2**i, 8 // 2**i, c)) for i, c in enumerate(ch)]

    def biases():  # only the last convs' biases leave the function: XLA drops the rest
        out = {}
        for k, m in jax_heads.items():
            flat = jax.tree_util.tree_flatten_with_path(m.init(jax.random.PRNGKey(0), xs)["params"])[0]
            out[k] = {"/".join(str(p.key) for p in path): a for path, a in flat
                      if path[-1].key == "bias" and path[-2].key.endswith("_2")}
        return out

    ref = jax.tree.map(np.asarray, jax.jit(biases)())
    for k, head in heads.items():
        got = {n: t for n, t in state_dict_from_jax({"params": {"model_0": _nest(ref[k])}}).items()}
        assert len(got) == {"v8": 6, "11": 6, "v10": 12, "seg": 9}[k]
        for name, want in got.items():
            t = head.state_dict()[name.removeprefix(f"model.0.")]
            assert torch.equal(t, want), (k, name)
    assert float(heads["v8"].cv3[0][2].bias[0].detach()) == pytest.approx(np.log(5 / 80 / 80**2))


def _nest(flat):
    """{"a/b/bias": x} -> {"a": {"b": {"bias": x}}}."""
    out = {}
    for key, a in flat.items():
        node = out
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = a
    return out


# ---------------------------------------------------------------------------------------------------------------
# graphs


@functools.cache
def graph(cfg):
    """(seeded JAX variables, the port model loaded strictly, JAX's eval
    output on GRAPH_X: (prediction, (maps, coefficients, prototypes))), one jax.jit."""
    jm = JaxDetectionModel(cfg, nc=NC)
    v = seeded_variables(jm, 64, np.random.default_rng(0))
    pm = DetectionModel(cfg_nc(cfg), device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    fwd, x = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False)), jnp.asarray(GRAPH_X)
    out = fwd.lower(v, x).compile(compiler_options=QUICK)(v, x)
    return v, pm, jax.tree.map(np.asarray, out)


def assert_seg_close(got, ref, tol=GRAPH_TOL, nm=32):
    """(maps, coefficients (B, A, nm), prototypes NCHW) against JAX's (NHWC maps and prototypes)."""
    maps, mc, proto = got
    rmaps, rmc, rproto = ref
    assert len(maps) == len(rmaps) == 3 and tuple(proto.shape) == (2, nm, 16, 16) and tuple(mc.shape) == (2, 84, nm)
    for f, rf in zip(maps, rmaps):
        close(nhwc(f), rf, tol)
    close(mc.detach().numpy(), rmc, tol)
    close(nhwc(proto), rproto, tol)


HEAD_CH = (16, 32, 64)  # Segment's input channels at module level; maps 8x8, 4x4, 2x2 (a 64 px input)


@functools.cache
def head_run():
    """Segment (its v8 cls branch; yolo11n-seg's graph test holds YOLO11's)
    with nm 8 and npr 24 at module level: seeded variables, inputs, its eval
    output, train output and moved batch_stats, one jax.jit."""
    rng = np.random.default_rng(12)
    xs = [rng.normal(0, 1, (2, 8 // 2**i, 8 // 2**i, c)).astype(np.float32) for i, c in enumerate(HEAD_CH)]
    jm = JH.Segment(nc=NC, nm=8, npr=24, ch=HEAD_CH)
    v = seeded_module(jm, [jnp.asarray(x) for x in xs], rng)

    def run(vv, xx):
        train, moved = jm.apply(vv, xx, train=True, mutable=["batch_stats"])
        return jm.apply(vv, xx, train=False), train, moved["batch_stats"]

    return v, xs, jax.tree.map(np.asarray, jax.jit(run)(v, [jnp.asarray(x) for x in xs]))


@pytest.mark.parametrize("train", [False, True])
def test_segment_head_matches_jax(train):
    """Proto and Segment at module level, fp32 within 1e-5: eval mode's
    (B, 4 + nc + nm, A) prediction and (maps, coefficients, prototypes);
    train mode's (maps, coefficients, prototypes) and the moved statistics."""
    v, xs, ((ref, ref_aux), ref_train, moved) = head_run()
    pm = load_module(M.Segment(NC, HEAD_CH, nm=8, npr=24), v).train(train)
    assert isinstance(pm.proto, M.Proto) and pm.cv4[0][0].conv.out_channels == max(HEAD_CH[0] // 4, 8)
    with torch.no_grad():
        out = pm([to_torch(x) for x in xs])
    if train:
        assert_seg_close(out, ref_train, MOD_TOL, nm=8)
        assert_stats_moved(pm, moved)
    else:
        assert out[0].shape == ref.shape == (2, 4 + NC + 8, 84)
        close(out[0].numpy(), ref, MOD_TOL)
        assert_seg_close(out[1], ref_aux, MOD_TOL, nm=8)


@pytest.mark.parametrize("cfg,how", [(c, h) for c in GRAPHS for h in ("unfused", "port_fuse", "jax_folded_tree")
                                      if not (c != GRAPHS[0] and h == "jax_folded_tree")])
def test_graph_matches_jax(cfg, how):
    """Eval mode: the decoded prediction (4 + nc + nm channels; boxes within
    GRAPH_TOL of the largest box) and the raw maps, coefficients and
    prototypes. The port's fuse() and JAX's fuse_variables tree (read by
    fused_state_from_jax) equal each other; the transposed conv stays as it is."""
    v, pm, (ref, ref_aux) = graph(cfg)
    if how == "port_fuse":
        pm = copy.deepcopy(pm).fuse()
        assert pm.is_fused and isinstance(pm.model[-1].proto.upsample, torch.nn.ConvTranspose2d)
    elif how == "jax_folded_tree":
        own = copy.deepcopy(pm).fuse()
        pm = DetectionModel(cfg_nc(cfg), device="cpu").fuse()
        pm.load_state_dict(fused_state_from_jax(jax.tree.map(np.asarray, jax.jit(fuse_variables)(v))), strict=True)
        for k, t in own.state_dict().items():
            close(pm.state_dict()[k].numpy(), t.numpy(), 1e-6)
    with torch.no_grad():
        out, aux = pm(to_torch(GRAPH_X))
    assert out.shape == ref.shape == (2, 4 + NC + 32, 84) and out.dtype == torch.float32
    np.testing.assert_allclose(out[:, :4].numpy(), ref[:, :4], rtol=GRAPH_TOL, atol=GRAPH_TOL * np.abs(ref[:, :4]).max())
    close(out[:, 4:].numpy(), ref[:, 4:], GRAPH_TOL)
    assert_seg_close(aux, ref_aux)


@pytest.mark.parametrize("cfg", list(JAX_PARAMS))
def test_seg_yamls_build_with_jax_param_counts(cfg):
    """Each packaged seg YAML builds (on the meta device) with JAX's parameter
    count and ends in Segment: task "segment", a refused ensemble member; its
    ungrouped convs take conv_int8's geometry."""
    with torch.device("meta"):
        pm = DetectionModel(cfg, device="meta")
    assert_int8_geometry(pm)
    assert sum(p.numel() for p in pm.parameters()) == JAX_PARAMS[cfg]
    assert pm.task == "segment" and isinstance(pm.model[-1], M.Segment) and not pm.end2end
    assert len(pm.strides) == (4 if "p6" in cfg else 3)


@pytest.mark.parametrize("cfg", GRAPHS)
def test_bridge_both_ways(cfg):
    """Every JAX leaf names one port tensor (the detect branches without
    JAX's `detect` scope, proto.upsample flipped as a transposed conv) and
    the port has no other; the state written back is JAX's tree, bit for bit."""
    v, pm, _ = graph(cfg)
    names = set(pm.state_dict())
    head = f"model.{len(pm.model) - 1}"
    assert {f"{head}.proto.upsample.weight", f"{head}.proto.cv3.conv.weight", f"{head}.cv4.2.2.bias",
            f"{head}.cv2.0.2.bias", f"{head}.cv3.1.2.weight"} <= names
    assert not any(".detect." in n or ".dfl." in n for n in names)
    up = pm.model[-1].proto.upsample.weight.detach().numpy()
    jk = v["params"][f"model_{len(pm.model) - 1}"]["proto"]["upsample"]["kernel"]
    np.testing.assert_array_equal(up, jk[::-1, ::-1].transpose(2, 3, 0, 1))
    back = jax_variables_from_state(pm)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    want, got = flat({k: v[k] for k in ("params", "batch_stats")}), flat(back)
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)


def test_ckpt_and_pt_round_trips(tmp_path):
    """YOLO.save of yolov8n-seg as a JAX-format .ckpt and as a .pt (and the
    BN-folded .ckpt), each read back by YOLO(path): the same state, bit for bit."""
    y = YOLO(cfg_nc(GRAPHS[0]), device="cpu")
    y.model.load_state_dict(graph(GRAPHS[0])[1].state_dict())
    for name in ("m.ckpt", "m.pt"):
        y.save(str(tmp_path / name))
        back = YOLO(str(tmp_path / name), device="cpu")
        assert back.task == "segment" and back.model.nc == NC
        want = y.model.state_dict()
        assert all(torch.equal(t, want[k]) for k, t in back.model.state_dict().items())
    y.fuse().save(str(tmp_path / "f.ckpt"))
    back = YOLO(str(tmp_path / "f.ckpt"), device="cpu")
    assert back.is_fused and all(torch.equal(t, y.model.state_dict()[k]) for k, t in back.model.state_dict().items())


def test_int8_export_and_ensemble_refuse_segment():
    """int8 and export take a seg model now (both were refused until this
    slice): quantize_model gives every Conv int8 weights and leaves Proto's
    transposed conv and cv4's last 1x1 float, and the exporter's forward
    returns the prediction and the prototypes, its sidecar saying segment
    (the program itself: tests/test_torch_export.py); what is refused is
    nms=True on it (ValueError, as the JAX exporter) and an ensemble with a
    seg member."""
    from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.exporter import Exporter, ExportForward

    pm = copy.deepcopy(graph(GRAPHS[0])[1]).fuse()
    quantize_model(pm, [np.zeros((1, 64, 64, 3), np.uint8)])
    head = pm.model[-1]
    assert all(c.w_int8 is not None for c in pm.modules() if isinstance(c, M.Conv))
    assert isinstance(head.proto.upsample, torch.nn.ConvTranspose2d) and not isinstance(head.cv4[0][2], M.Conv)
    with torch.no_grad():
        out, (_, mc, proto) = pm(torch.from_numpy(GRAPH_X).permute(0, 3, 1, 2))
    assert tuple(out.shape) == (2, 4 + NC + 32, 84) and tuple(proto.shape) == (2, 32, 16, 16)
    fm = graph(GRAPHS[0])[1]
    with torch.no_grad():
        pred, protos = ExportForward(fm)(torch.from_numpy(FRAMES))
        ref, (_, _, rproto) = fm(torch.from_numpy(GRAPH_X).permute(0, 3, 1, 2))
    assert pred.dtype == protos.dtype == torch.float32
    assert torch.equal(pred, ref) and torch.equal(protos, rproto)
    ex = Exporter(fm, get_cfg({"imgsz": 64}))
    md = ex._metadata(64, ex._resolve_options(), False)
    assert md["task"] == "segment" and "prototypes" in md["layout"]
    with pytest.raises(ValueError, match="detect-task"):
        Exporter(fm, get_cfg({"imgsz": 64, "nms": True}))._resolve_options()
    with pytest.raises(ValueError, match="segmentation member"):
        EnsembleModel([DetectionModel(cfg_nc("yolov8n.yaml"), device="cpu"), graph(GRAPHS[0])[1]])


INT8_FRAMES = np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)


@functools.cache
def int8_run():
    """(port, JAX) int8 paths of yolov8n-seg's seeded weights on INT8_FRAMES (one batch), JAX's forward on GRAPH_X."""
    v, pm = graph(GRAPHS[0])[:2]
    return port_int8(pm, INT8_FRAMES), jax_int8(JaxDetectionModel(GRAPHS[0], nc=NC), v, INT8_FRAMES, GRAPH_X)


def test_int8_calibration_matches_jax():
    assert_calibration_close(*int8_run())


def test_int8_quant_state_matches_jax():
    assert_quant_state_close(*int8_run())


def test_int8_graph_matches_jax():
    """yolov8n-seg's int8 graph with JAX's quant state carried in against
    JAX's int8 graph: the decoded boxes, class scores and coefficients, the
    raw maps and the prototypes within OUT_TOL."""
    port, ref = int8_run()
    m = int8_with_jax_state(port, ref)
    with torch.no_grad():
        out, (maps, mc, proto) = m(torch.from_numpy(GRAPH_X).permute(0, 3, 1, 2))
    rout, (rmaps, rmc, rproto) = ref["out"]
    for a, b in ((0, 4), (4, 4 + NC), (4 + NC, 4 + NC + 32)):
        assert_out_close(out[:, a:b].numpy(), rout[:, a:b])
    for f, rf in zip(maps, rmaps):
        assert_out_close(nhwc(f), rf)
    assert_out_close(mc.numpy(), rmc)
    assert_out_close(nhwc(proto), rproto)


# ---------------------------------------------------------------------------------------------------------------
# NMS, masks, fill_poly


@pytest.mark.parametrize("multi_label", [False, True])
def test_nms_carries_mask_coefficients_as_jax(multi_label):
    """(B, 4 + nc + 32, A) with ties and more candidates than MAX_NMS: the
    (B, max_det, 6 + 32) rows equal JAX's bit for bit."""
    nc, a = 3, MAX_NMS + 300
    rng = np.random.default_rng(3 + multi_label)
    pred = np.concatenate([random_prediction(rng, 2, nc, a, True),
                           rng.normal(0, 1, (2, 32, a)).astype(np.float32)], 1)
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=40, nc=nc, multi_label=multi_label)
    ref = np.asarray(jax_nms(jnp.asarray(pred), max_nms=MAX_NMS, **kw))
    out = non_max_suppression(torch.from_numpy(pred), **kw).numpy()
    assert out.shape == (2, 40, 6 + 32)
    np.testing.assert_array_equal(out, ref)
    assert (out[..., 4] > 0).sum() > 40


def mask_case(seed=0, n=12, h=16, w=20, img=(64, 80)):
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (h, w, 32)).astype(np.float32)
    coeffs = rng.normal(0, 0.3, (n, 32)).astype(np.float32)
    xy = rng.uniform(-5, img[1] - 10, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(3, 40, (n, 2))], 1).astype(np.float32)
    return protos, coeffs, boxes


def test_process_mask_matches_jax():
    """Soft masks cropped at the prototypes' resolution, within 1e-6 (the
    product sums in another order)."""
    protos, coeffs, boxes = mask_case()
    ref = np.asarray(JB.process_mask(jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes), (64, 80)))
    got = PB.process_mask(torch.from_numpy(protos).permute(2, 0, 1), torch.from_numpy(coeffs),
                          torch.from_numpy(boxes), (64, 80)).numpy()
    assert got.shape == (12, 16, 20)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (got == 0).any() and (got > 0.5).any()


@pytest.mark.parametrize("img_shape", [(100, 140), (30, 40)])
def test_process_mask_native_matches_jax(img_shape):
    """Native-resolution boolean masks (the letterbox pad cut, resized up, or
    down with antialiasing, cropped, logit > 0): all but 0.5 % of pixels."""
    protos, coeffs, _ = mask_case(1)
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, img_shape[1] * 0.6, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, img_shape[0] * 0.5, (12, 2))], 1).astype(np.float32)
    ref = np.asarray(JB.process_mask_native(jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes), img_shape))
    got = PB.process_mask_native(torch.from_numpy(protos).permute(2, 0, 1), torch.from_numpy(coeffs),
                                 torch.from_numpy(boxes), img_shape).numpy()
    assert got.shape == ref.shape == (12, *img_shape) and got.dtype == bool
    assert (got != ref).mean() <= 5e-3 and ref.any()


POLYGONS = {
    "convex": (40, 30, [[5, 5], [30, 4], [36, 22], [12, 27]]),
    "concave": (40, 30, [[2, 2], [37, 2], [37, 27], [20, 10], [2, 27]]),
    "self_intersecting": (40, 30, [[3, 3], [36, 26], [36, 3], [3, 26]]),
    "degenerate_point": (40, 30, [[7, 9]]),
    "degenerate_segment": (40, 30, [[7, 9], [31, 20]]),
    "collinear": (40, 30, [[1, 1], [10, 10], [20, 20]]),
    "off_canvas": (40, 30, [[-20, -8], [70, 5], [50, 60], [-3, 40]]),
    "degenerate_clip": (53, 22, [[37, 16], [55, 0], [50, 38], [15, 43], [24, 50], [59, 16]]),
    "outside": (40, 30, [[50, 5], [80, 5], [70, 25]]),
}


@pytest.mark.parametrize("name", list(POLYGONS))
def test_fill_poly_equals_cv2(name):
    w, h, pts = POLYGONS[name]
    pts = np.array(pts, np.int32)
    for dtype, color in ((np.uint8, 1), (np.int32, 7)):
        a, b = np.zeros((h, w), dtype), np.zeros((h, w), dtype)
        cv2.fillPoly(a, [pts], color)
        fill_poly(b, pts, color)
        np.testing.assert_array_equal(b, a)


def test_fill_poly_equals_cv2_on_random_polygons():
    """1500 random polygons of 1 to 13 vertices on canvases of 3 to 70
    pixels, a third of them reaching far off the canvas: bit for bit."""
    rng = np.random.default_rng(17)
    for t in range(1500):
        w, h = (int(v) for v in rng.integers(3, 70, 2))
        lo, hi = [(-40, 110), (0, 70), (-300, 300)][t % 3]
        pts = rng.integers(lo, hi, (int(rng.integers(1, 14)), 2)).astype(np.int32)
        a, b = np.zeros((h, w), np.int32), np.zeros((h, w), np.int32)
        cv2.fillPoly(a, [pts], t % 200 + 1)
        fill_poly(b, pts, t % 200 + 1)
        assert np.array_equal(a, b), (w, h, pts.tolist())


@pytest.mark.parametrize("retina", [False, True])
@pytest.mark.parametrize("orig", [(48, 64), (64, 40), (150, 100)])
def test_predictor_masks_match_jax_host_path(orig, retina):
    """native_masks (the port's predictor, F.interpolate) against the JAX
    predictor's _postprocess_one (cv2.resize on the host) on the same kept
    rows, prototypes and coefficients: the same boxes, and masks of shape
    (n, H0, W0) that agree on all but 0.5 % of pixels."""
    imgsz, n = 64, 10
    protos, coeffs, boxes = mask_case(3, n=n, h=16, w=16, img=(imgsz, imgsz))
    boxes = np.clip(boxes, 0, imgsz)
    det = np.concatenate([boxes, np.linspace(0.9, 0.3, n, dtype=np.float32)[:, None],
                          np.zeros((n, 1), np.float32), coeffs], 1)
    r, _, (padw, _, padh, _) = letterbox_geometry(orig, imgsz)
    jp = JaxPredictor.__new__(JaxPredictor)
    jp.model, jp.args = SimpleNamespace(task="segment", names={0: "a"}), SimpleNamespace(retina_masks=retina)
    if retina:
        soft = jax.nn.sigmoid(jnp.asarray(coeffs) @ jnp.asarray(protos).reshape(-1, 32).T).reshape(-1, 16, 16)
    else:
        soft = JB.process_mask(jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes), (imgsz, imgsz))
    img0 = np.zeros((*orig, 3), np.uint8)
    ref = jp._postprocess_one(det.copy(), np.asarray(soft), img0, "x", imgsz, r, padw, padh, {})
    boxes0 = torch.from_numpy(ref.boxes.data[:, :4].copy())
    got = native_masks(torch.from_numpy(protos).permute(2, 0, 1), torch.from_numpy(det), imgsz, (padw, padh), orig,
                       boxes0, retina).numpy()
    want = np.asarray(ref.masks.data)
    assert got.shape == want.shape == (n, *orig) and got.dtype == bool
    assert (got != want).mean() <= 5e-3 and want.any()


def test_segmentation_validator_matches_jax():
    """The port's SegmentationValidator and JAX's on the same detections,
    masks and batches (their forwards replaced by the same arrays): every
    metric within 1e-12, the box and mask Metric bundles equal."""
    rng = np.random.default_rng(9)
    b, imgsz, md = 3, 64, 20
    batches, outs = [], []
    for k in range(2):
        seg_map = np.zeros((b, 16, 16), np.int32)
        cls = rng.integers(0, NC, (b, 6)).astype(np.float32)
        mask = (rng.random((b, 6)) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0  # JAX's validator fails on detections in an image without GT (ROADMAP.md Queue 3)
        boxes = np.zeros((b, 6, 4), np.float32)
        dets = np.zeros((b, md, 6), np.float32)
        pmasks = []
        for i in range(b):
            for g in range(6):
                x0, y0 = rng.integers(0, 10, 2)
                x1, y1 = x0 + rng.integers(3, 7), y0 + rng.integers(3, 7)
                seg_map[i, y0:y1, x0:x1] = g + 1
                boxes[i, g] = [(x0 + x1) / 32, (y0 + y1) / 32, (x1 - x0) / 16, (y1 - y0) / 16]
            n = int(rng.integers(0 if i == 0 and k == 0 else 3, md))
            gt = rng.integers(0, 6, n)
            jitter = rng.normal(0, 1.5, (n, 4))
            xyxy = np.concatenate([boxes[i, gt, :2] - boxes[i, gt, 2:] / 2, boxes[i, gt, :2] + boxes[i, gt, 2:] / 2], 1)
            dets[i, :n, :4] = xyxy * imgsz + jitter
            dets[i, :n, 4] = np.sort(rng.uniform(0.01, 1, n))[::-1]
            dets[i, :n, 5] = np.where(rng.random(n) < 0.8, cls[i, gt], rng.integers(0, NC, n))
            pm = (seg_map[i][None] == (gt[:, None, None] + 1)) ^ (rng.random((n, 16, 16)) < 0.05)
            pmasks.append(pm)
        batches.append({"img": np.zeros((b, imgsz, imgsz, 3), np.uint8), "cls": cls, "bboxes": boxes, "mask": mask,
                        "seg_map": seg_map})
        outs.append((dets, pmasks))
    args = SimpleNamespace(imgsz=imgsz, max_det=md, verbose=False, plots=False, save_json=False, project=None,
                           name=None)
    model = SimpleNamespace(names={0: "a", 1: "b"}, nc=NC, eval=lambda: None)
    pv = SegmentationValidator(model, batches, args)
    it = iter(outs)
    pv.forward_nms = lambda img: next(it)
    got = pv()
    jv = JV.SegmentationValidator.__new__(JV.SegmentationValidator)
    jv.model, jv.args, jv.loader = model, args, batches
    full = [(np.pad(d, ((0, 0), (0, 0), (0, 0))), np.stack([np.pad(m, ((0, md - len(m)), (0, 0), (0, 0)))
                                                            for m in pm])) for d, pm in outs]
    jit = iter(full)
    jv._forward_nms = lambda variables, img: next(jit)
    ref = jv(None)
    assert got.keys() == ref.keys() and got["mAP50(M)"] > 0
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-12), k
    assert pv.box_m.box.mean_results() == pytest.approx(jv.box_m.box.mean_results(), abs=1e-12)
    assert pv.mask_m.box.mean_results() == pytest.approx(jv.mask_m.box.mean_results(), abs=1e-12)


# ---------------------------------------------------------------------------------------------------------------
# YOLO end to end on the CPU


def write_polygon_dataset(root, n_train=4, n_val=4):
    """A tiny YOLO segmentation dataset (PNGs, polygon labels, 2 classes): 1 to 3 filled polygons per image."""
    rng = np.random.default_rng(11)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = (96, 128) if i % 2 else (128, 96)
            img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            lines = []
            for j in range(int(rng.integers(1, 4))):
                c, rad = rng.uniform(0.3, 0.7, 2), rng.uniform(0.1, 0.25)
                ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
                p = np.clip(np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], 1), 0, 1)
                cv2.fillPoly(img, [np.round(p * [w, h]).astype(np.int32)], (200, 100 + 50 * j, 60))
                lines.append(f"{j % 2} " + " ".join(f"{v:.5f}" for v in p.reshape(-1)))
            if i == 1:  # a box row beside the polygons
                lines.append("1 0.5 0.5 0.2 0.3")
            cv2.imwrite(str(root / "images" / split / f"{i}.png"), img)
            (root / "labels" / split / f"{i}.txt").write_text("\n".join(lines) + "\n")
    data = root / "data.yaml"
    data.write_text(json.dumps({"path": str(root), "train": "images/train", "val": "images/val", "nc": NC,
                                "names": {"0": "a", "1": "b"}}))
    return data


def test_yolo_trains_validates_and_predicts_masks(tmp_path, monkeypatch):
    """YOLO("yolov8n-seg.yaml", device="cpu"): train for one epoch of 2
    micro-steps at 64 px in fp32 (the host stack, the seg loss, val each epoch:
    results.csv with train/seg_loss, best.pt), YOLO(best.pt).val equal to
    the trainer's record, and predict: masks (n, H0, W0) bool, each inside
    its box plus one pixel, with and without retina_masks."""
    monkeypatch.setitem(PS.SETTINGS, "tensorboard", False)
    data = write_polygon_dataset(tmp_path / "data")
    y = YOLO("yolov8n-seg.yaml", device="cpu")
    assert y.task == "segment"
    record = y.train(data=str(data), epochs=1, batch=2, nbs=2, imgsz=64, workers=1, project=str(tmp_path / "runs"),
                     verbose=False, amp=False)
    assert y.trainer.step == 2 and y.trainer.train_loader.device_augment is False
    csv = (y.trainer.save_dir / "results.csv").read_text().splitlines()
    assert "train/seg_loss" in csv[0] and "metrics/mAP50-95(M)" in csv[0]
    assert all(np.isfinite(float(v)) for v in csv[1].split(","))
    best = YOLO(str(y.trainer.wdir / "best.pt"), device="cpu")
    vm = best.val(data=str(data), batch=2, imgsz=64, workers=1, verbose=False)
    assert {k: record[k] for k in record} == pytest.approx({k: vm[k] for k in record}, abs=1e-6)
    assert vm.seg is not None and vm.box is not None and "metrics/mAP50(M)" in vm.results_dict
    zero_class_priors(best.model)  # the predictor at full load: seeded scores near 0.5
    for retina in (False, True):
        res = best.predict(str(data.parent / "images" / "val"), imgsz=64, conf=0.25, retina_masks=retina,
                           verbose=False)
        assert len(res) == 4 and sum(len(r) for r in res) > 0
        for r in res:
            assert r.masks.data.dtype == bool and r.masks.shape == (len(r), *r.orig_shape)
            for m, box in zip(r.masks.data, r.boxes.xyxy):
                ys, xs = np.nonzero(m)
                if len(xs):
                    assert xs.min() >= box[0] - 1 and xs.max() <= box[2] + 1
                    assert ys.min() >= box[1] - 1 and ys.max() <= box[3] + 1
            sub = r[:2]
            assert sub.masks.shape == (min(2, len(r)), *r.orig_shape)
