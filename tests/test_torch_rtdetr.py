"""RT-DETR in the port vs the JAX package, in eval, on the same weights and inputs.

Modules, fp32, on seeded numpy variables carried in by the weight bridge
(every kernel and bias random, so no branch hides behind a zero init):
HGStem on an odd-sized input, HGBlock plain and light with its shortcut,
RepC3 with and without its cv3, AIFI on a non-square map (the sincos
table's x-major quirk), MSDeformAttn with sampling points outside the map,
and RTDETRDecoder on maps 60 anchors wide, where the anchors outside (0.01,
0.99) score alike and carry +inf logits, with nq clamped to the anchor count
so that the tie order decides every query: each within MOD_TOL of the
largest magnitude (the same fp32 math in another order). The whole tiny graph
of the JAX package's tests/test_rtdetr.py at 64 px, unfused and BN-folded,
within GRAPH_TOL. All the JAX sides above run under one jax.jit.

Serving: the predictor's Results (scale-filled frames, normalised boxes
scaled by each original frame) and the validator's (B, nq, 6) conf-sorted
detections equal the JAX predictor's and validator's on the same frames
within GRAPH_TOL. The bridge both ways bit for bit, a .ckpt round trip,
the names and parameter counts of the five RT-DETR YAMLs on the meta
device (rtdetr-l 32,970,476; rtdetr-l and yolov8-rtdetr name for name
against jax.eval_shape, no init of rtdetr-l), RTDETR("yolov8n.yaml")
raising, and an nms=True export and ensembles refused.
"""

import copy
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from improving_yolov8_cbam_swinblock_tpu.engine.validator import DetectionValidator as JaxValidator
from improving_yolov8_cbam_swinblock_tpu.nn import modules_extra as JX
from improving_yolov8_cbam_swinblock_tpu.nn import transformer as JT
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, EnsembleModel, RTDETR, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg
from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import DetectionPredictor
from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import DetectionValidator
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.nn import transformer as T
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import jax_variables_from_state, state_dict_from_jax
from tests.test_torch_model import seeded_variables
from tests.test_torch_yolo11 import close, nhwc, seeded_module, to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
MOD_TOL = 1e-4
GRAPH_TOL = 2e-3
# the tiny graph of the JAX package's tests/test_rtdetr.py: 2 decoder layers, 16 queries
TINY_RTDETR = {
    "nc": 3,
    "backbone": [
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "Conv", [48, 3, 2]],
        [-1, 1, "Conv", [64, 3, 2]],
    ],
    "head": [
        [-1, 1, "AIFI", [64, 4]],
        [[2, 3, 5], 1, "RTDETRDecoder", ["nc", 32, 16, 2, 4, 2, 64]],
    ],
}
FRAMES = np.random.default_rng(22).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
# the parameter counts of the JAX package's abstract variables (shape_init), which the port's names and shapes equal
PARAMS = {"rtdetr-l.yaml": 32970476, "rtdetr-x.yaml": 67467852, "rtdetr-resnet50.yaml": 42925132,
          "rtdetr-resnet101.yaml": 61917260, "yolov8-rtdetr.yaml": 9643868}
DECODER_SHAPES = ((2, 60, 16), (1, 30, 24), (1, 15, 32))  # (h, w, c): 165 anchors, 4 outside (0.01, 0.99)


def module_cases():
    """{name: (JAX module, port module, NHWC input)}; the port module's
    weights come from the JAX module's seeded variables (jax_side)."""
    rng = np.random.default_rng(9)
    x = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    cases = {
        "hgstem": (JX.HGStem(8, 16), M.HGStem(3, 8, 16), x(2, 17, 18, 3)),
        "hgblock": (JX.HGBlock(8, 16, k=3, n=2), M.HGBlock(12, 8, 16, k=3, n=2), x(2, 6, 7, 12)),
        "hgblock_light_shortcut": (JX.HGBlock(8, 16, k=5, n=2, lightconv=True, shortcut=True),
                                   M.HGBlock(16, 8, 16, k=5, n=2, lightconv=True, shortcut=True), x(2, 6, 7, 16)),
        "repc3": (JX.RepC3(16, n=2), M.RepC3(12, 16, n=2), x(2, 5, 6, 12)),
        "repc3_cv3": (JX.RepC3(16, n=1, e=0.5), M.RepC3(12, 16, n=1, e=0.5), x(2, 5, 6, 12)),
        "aifi": (JT.AIFI(32, 4), T.AIFI(16, 32, 4), x(2, 3, 5, 16)),
    }
    return cases


def deform_case():
    """MSDeformAttn (2 levels, 2 heads, 3 points) on (B, Lq) = (2, 5)
    queries whose boxes touch or cross the map's edges, its offset kernel
    scaled so that many points fall outside the map."""
    rng = np.random.default_rng(10)
    shapes = ((4, 5), (2, 3))
    q = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    refer = np.concatenate([rng.uniform(-0.1, 1.1, (2, 5, 1, 2)), rng.uniform(0.1, 0.8, (2, 5, 1, 2))],
                           -1).astype(np.float32)
    value = rng.normal(0, 1, (2, sum(h * w for h, w in shapes), 16)).astype(np.float32)
    return JT.MSDeformAttn(2, 2, 3), T.MSDeformAttn(16, 2, 2, 3), (q, refer, value), shapes


def decoder_case():
    rng = np.random.default_rng(11)
    jm = JT.RTDETRDecoder(nc=3, ch=tuple(c for _, _, c in DECODER_SHAPES), hd=32, nq=180, ndp=2, nh=2, ndl=2,
                          d_ffn=48)
    pm = T.RTDETRDecoder(3, [c for _, _, c in DECODER_SHAPES], hd=32, nq=180, ndp=2, nh=2, ndl=2, d_ffn=48)
    xs = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for h, w, c in DECODER_SHAPES]
    return jm, pm, xs


@pytest.fixture(scope="module")
def jax_side():
    """Seeded variables for every case and the JAX outputs of all of them,
    the tiny graph's too, under one jax.jit."""
    rng = np.random.default_rng(12)
    mods = module_cases()
    variables = {k: seeded_module(jm, jnp.asarray(xs), rng) for k, (jm, _, xs) in mods.items()}
    djm, dpm, (q, refer, value), shapes = deform_case()
    dv = variables_of(djm, (q, refer, value), shapes, rng)
    dv["params"]["sampling_offsets"]["kernel"] = dv["params"]["sampling_offsets"]["kernel"] * 8.0
    cjm, cpm, cxs = decoder_case()
    cv = seeded_module(cjm, [jnp.asarray(x) for x in cxs], rng)
    gjm = JaxDetectionModel(dict(TINY_RTDETR))
    gv = seeded_variables(gjm, 64, rng)

    def run(vs, ins):
        out = {k: mods[k][0].apply(vs[k], ins[k], train=False) for k in mods}
        out["deform"] = djm.apply(vs["deform"], *ins["deform"], shapes)
        out["decoder"] = cjm.apply(vs["decoder"], ins["decoder"], train=False)[0]
        out["graph"] = gjm.apply(vs["graph"], ins["graph"], train=False)[0]
        return out

    vs = {**variables, "deform": dv, "decoder": cv, "graph": gv}
    ins = {**{k: jnp.asarray(xs) for k, (_, _, xs) in mods.items()}, "deform": (q, refer, value),
           "decoder": [jnp.asarray(x) for x in cxs], "graph": jnp.asarray(FRAMES.astype(np.float32) / 255.0)}
    out = jax.tree.map(np.asarray, jax.jit(run)(vs, ins))
    return {"vars": vs, "out": out, "graph_model": gjm}


def variables_of(jm, inputs, shapes, rng):
    """seeded_module for a module whose call takes static value shapes
    (MSDeformAttn): every leaf random, the 1-D ones normal(0, 0.1)."""
    abstract = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *inputs, shapes))

    def leaf(s):
        if s.ndim < 2:
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        bound = np.sqrt(1.0 / np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree.map(leaf, abstract)


def port_module(pm, v):
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return pm.eval().to(memory_format=torch.channels_last)


@functools.cache
def tiny_port():
    return DetectionModel(dict(TINY_RTDETR), device="cpu")


def tiny_loaded(jax_side):
    pm = copy.deepcopy(tiny_port())
    pm.load_state_dict(state_dict_from_jax(jax_side["vars"]["graph"]), strict=True)
    return pm


@pytest.mark.parametrize("name", ["hgstem", "hgblock", "hgblock_light_shortcut", "repc3", "repc3_cv3", "aifi"])
def test_module_matches_jax(jax_side, name):
    """Each module's eval output within MOD_TOL of JAX's on the same weights."""
    _, pm, xs = module_cases()[name]
    pm = port_module(pm, jax_side["vars"][name])
    with torch.no_grad():
        out = pm(to_torch(xs))
    ref = jax_side["out"][name]
    assert nhwc(out).shape == ref.shape
    close(nhwc(out), ref, MOD_TOL)
    if name == "repc3_cv3":
        assert isinstance(pm.cv3, M.Conv)
    if name == "hgblock_light_shortcut":
        assert pm.add and isinstance(pm.m[0], M.LightConv) and pm.m[0].conv2.conv.groups == 8


def test_sincos_table_keeps_the_x_major_quirk():
    """The table is built over (w, h) with indexing 'ij' while the features
    flatten (h, w): row x * h + y holds the position (x, y)."""
    tab = T.sincos_2d_pos(5, 3, 16)[0]
    np.testing.assert_array_equal(tab, np.asarray(JT.sincos_2d_pos(5, 3, 16))[0])
    assert tab.shape == (15, 16)
    np.testing.assert_allclose(tab[1 * 3 + 2, 0], np.sin(1.0), rtol=1e-6)  # x = 1 at row 5 (y = 2)
    np.testing.assert_allclose(tab[1 * 3 + 2, 8], np.sin(2.0), rtol=1e-6)


def test_msdeformattn_matches_jax_outside_the_map(jax_side):
    """Deformable attention within MOD_TOL of JAX's four corner gathers, with
    more than a quarter of the sampling points outside the map (their
    out-of-range corners weigh 0 in both)."""
    _, pm, (q, refer, value), shapes = deform_case()
    pm.load_state_dict(state_dict_from_jax(jax_side["vars"]["deform"]), strict=True)
    with torch.no_grad():
        off = pm.sampling_offsets(torch.from_numpy(q)).reshape(2, 5, 2, 2, 3, 2)
        loc = torch.from_numpy(refer)[:, :, None, :, None, :2] + off / 3 * torch.from_numpy(refer)[:, :, None, :, None, 2:] * 0.5
        out = pm(torch.from_numpy(q), torch.from_numpy(refer), torch.from_numpy(value), shapes)
    outside = ((loc < 0) | (loc > 1)).any(-1).float().mean()
    assert outside > 0.25
    close(out.numpy(), jax_side["out"]["deform"], MOD_TOL)


def test_decoder_eval_matches_jax_with_ties_and_inf_anchors(jax_side):
    """RTDETRDecoder in eval: nq (180) clamped to the 165 anchors, so the
    top-k orders every anchor, the four invalid ones (equal scores, +inf
    logits) by their index: (B, 165, 4 + nc) within MOD_TOL of JAX's."""
    _, pm, xs = decoder_case()
    pm.load_state_dict(state_dict_from_jax(jax_side["vars"]["decoder"]), strict=True)
    pm.eval()
    anchors, valid = pm.anchors([(h, w) for h, w, _ in DECODER_SHAPES], "cpu")
    assert int((valid == 0).sum()) == 4 and bool(torch.isinf(anchors).any())
    with torch.no_grad():
        y, aux = pm([to_torch(x) for x in xs])
    ref = jax_side["out"]["decoder"]
    assert aux is None and y.shape == ref.shape == (2, 165, 7)
    close(y.numpy(), ref, MOD_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_graph_eval_matches_jax(jax_side, fused):
    """The tiny graph at 64 px: (B, 16, 4 + nc) sigmoid boxes and scores
    within GRAPH_TOL of JAX's, BN-folded by the port or not."""
    pm = tiny_loaded(jax_side)
    if fused:
        pm.fuse()
        assert pm.is_fused
    with torch.no_grad():
        y, _ = pm(to_torch(FRAMES.astype(np.float32) / 255.0))
    ref = jax_side["out"]["graph"]
    assert y.shape == ref.shape == (2, 16, 7)
    assert pm.is_rtdetr and pm.task == "detect" and pm.strides == (8, 16, 32) and not pm.end2end
    close(y.numpy(), ref, GRAPH_TOL)


def test_bridge_both_ways_and_ckpt_round_trip(jax_side, tmp_path):
    """AIFI's enc scope, input_proj_0, decoder_layers_0, enc_output_0, an
    MLP's layers_0 and the embedding table map to the reference's names; the
    tree written back is JAX's bit for bit; a .ckpt written and read back
    gives the same state."""
    pm = tiny_loaded(jax_side)
    names = set(pm.state_dict())
    assert {"model.5.ma.in_proj_weight", "model.5.fc1.weight", "model.5.norm2.bias",
            "model.6.input_proj.0.conv.weight", "model.6.input_proj.2.bn.running_var",
            "model.6.decoder.layers.1.cross_attn.sampling_offsets.bias", "model.6.decoder.layers.0.self_attn.out_proj.weight",
            "model.6.enc_output.0.weight", "model.6.enc_output.1.weight", "model.6.enc_bbox_head.layers.2.bias",
            "model.6.dec_bbox_head.1.layers.0.weight", "model.6.dec_score_head.0.bias",
            "model.6.query_pos_head.layers.1.weight", "model.6.denoising_class_embed.weight"} <= names
    v = jax_side["vars"]["graph"]
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(a) for k, a in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat({k: v[k] for k in ("params", "batch_stats")}), flat(jax_variables_from_state(pm))
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)
    y = YOLO(dict(TINY_RTDETR), device="cpu")
    y.model.load_state_dict(pm.state_dict())
    y.save(str(tmp_path / "tiny.ckpt"))
    back = YOLO(str(tmp_path / "tiny.ckpt"), device="cpu").model.state_dict()
    assert all(torch.equal(back[k], t) for k, t in pm.state_dict().items())


@pytest.mark.parametrize("cfg", sorted(PARAMS))
def test_yaml_builds_on_meta_with_its_parameter_count(cfg):
    """Each RT-DETR YAML builds (meta device, nothing allocated) with the JAX
    package's parameter count; rtdetr-l and yolov8-rtdetr name for name and
    shape for shape against JAX's abstract variables (a strict load)."""
    with torch.device("meta"):
        pm = DetectionModel(cfg, device="meta")
    assert sum(p.numel() for p in pm.parameters()) == PARAMS[cfg]
    assert pm.is_rtdetr and isinstance(pm.model[-1], T.RTDETRDecoder) and pm.strides == (8, 16, 32)
    if cfg in ("rtdetr-l.yaml", "yolov8-rtdetr.yaml"):
        shapes = JaxDetectionModel(cfg).shape_init(imgsz=64)  # jax.eval_shape of the init: no compile, no init
        state = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                                 {k: shapes[k] for k in ("params", "batch_stats")}))
        assert state.keys() == pm.state_dict().keys()
        assert all(tuple(state[k].shape) == tuple(t.shape) for k, t in pm.state_dict().items())
        pm.load_state_dict(state, strict=True, assign=True)


def test_predictor_matches_jax(jax_side):
    """YOLO.predict's path: frames scale-filled to 64 px (a 64x64 frame as it
    is, an 80x60 one stretched), the queries' boxes scaled by each original
    frame, unclipped, in query order, gated by conf: the JAX predictor's
    Results on the 64x64 frames within GRAPH_TOL, and the stretched frame's
    boxes the port's own forward on its resized frame times its size."""
    pm = tiny_loaded(jax_side)
    frames = [(np.ascontiguousarray(FRAMES[i][..., ::-1]), f"f{i}") for i in range(2)]
    jp = JaxPredictor(jax_side["graph_model"], SimpleNamespace(conf=0.3, iou=0.7, max_det=300, augment=False,
                                                                 agnostic_nms=False, verbose=False, visualize=False,
                                                                 retina_masks=False))
    ref = jp._run_batch(jax_side["vars"]["graph"], frames, 64)
    pp = DetectionPredictor(pm, get_cfg({"conf": 0.3, "verbose": False}))
    got = pp.run_batch(frames, 64, 2)
    for g, r in zip(got, ref):
        assert len(g.boxes.data) == len(r.boxes.data) > 0
        close(np.asarray(g.boxes.data), np.asarray(r.boxes.data), GRAPH_TOL)
    odd = np.random.default_rng(5).integers(0, 256, (80, 60, 3), dtype=np.uint8)
    res = pp.run_batch([(odd, "odd")], 64, 1)[0]
    x = torch.nn.functional.interpolate(torch.from_numpy(odd[..., ::-1].copy()).permute(2, 0, 1)[None].float(),
                                        size=(64, 64), mode="bilinear", align_corners=False).round().clamp(0, 255)
    with torch.no_grad():
        y = pm(x / 255.0)[0][0]
    keep = y[:, 4:].max(-1).values > 0.3
    boxes = torch.cat([y[:, :2] - y[:, 2:4] / 2, y[:, :2] + y[:, 2:4] / 2], -1)[keep] * torch.tensor([60, 80, 60, 80])
    np.testing.assert_allclose(np.asarray(res.boxes.data)[:, :4], boxes.numpy(), rtol=1e-5, atol=1e-4)


def test_validator_matches_jax(jax_side):
    """The validator's forward: all 16 queries of each image, boxes xyxy in
    input pixels, sorted by score (stable), no NMS: within GRAPH_TOL of the
    JAX validator's _forward_nms."""
    pm = tiny_loaded(jax_side)
    args = SimpleNamespace(imgsz=64, max_det=300, plots=False, save_json=False)
    ref = np.asarray(JaxValidator(jax_side["graph_model"], loader=None, args=args)._forward_nms(
        jax_side["vars"]["graph"], jnp.asarray(FRAMES)))
    got = DetectionValidator(pm, None, args).forward_nms(FRAMES)
    assert got.shape == ref.shape == (2, 16, 6)
    assert (np.diff(got[:, :, 4], axis=1) <= 0).all()
    close(got, ref, GRAPH_TOL)


def test_refusals():
    """RTDETR refuses a graph without RTDETRDecoder (as the JAX facade does);
    an export with nms=True refuses an RT-DETR graph (its queries need no
    NMS), and so do ensembles."""
    with pytest.raises(ValueError, match="RTDETRDecoder"):
        RTDETR("yolov8n.yaml", device="cpu")
    y = RTDETR(dict(TINY_RTDETR), device="cpu", param_dtype=torch.float32)
    assert y.task == "detect" and y.model.is_rtdetr
    with pytest.raises(ValueError, match="nothing to suppress"):
        y.export(imgsz=64, nms=True)
    with pytest.raises(ValueError, match="RT-DETR"):
        EnsembleModel([y.model])
    with pytest.raises(ValueError, match="no feature map"):
        y.model.embed(torch.zeros(1, 3, 64, 64), [6])


def test_cached_tables_serve_inference_then_training_and_int8():
    """The tables AIFI and the decoder cache per map size (positions,
    anchors) are plain tensors even when an inference-mode predict fills
    them: the same model then runs a train forward and backward, and
    quantize_model (whose calibration runs in inference mode) quantizes it,
    its input projections and backbone convs calibrated."""
    y = RTDETR(dict(TINY_RTDETR), device="cpu", param_dtype=torch.float32)
    y.predict(FRAMES[0], imgsz=64, conf=0.5, verbose=False)  # BN-folds and fills the tables in inference mode
    head = y.model.model[-1]
    assert all(not t.is_inference() for pair in head._anchor_cache.values() for t in pair)
    assert all(not t.is_inference() for t in y.model.model[5]._pos.values())
    m = DetectionModel(dict(TINY_RTDETR), device="cpu")
    m.model[5]._pos, m.model[-1]._anchor_cache = y.model.model[5]._pos, head._anchor_cache
    m.train()
    t = {"cls": torch.zeros(2, 2, dtype=torch.long), "bboxes": torch.full((2, 2, 4), 0.4),
         "mask": torch.ones(2, 2)}
    out = m(torch.from_numpy(FRAMES).permute(0, 3, 1, 2).float() / 255.0, targets=t)
    out["dec_scores"].float().sum().backward()
    assert m.model[0].conv.weight.grad is not None
    quantize_model(y.model, [FRAMES])
    assert y.model.model[-1].input_proj[0].runs_int8 and y.model.model[0].runs_int8
    assert len(y.predict(FRAMES[0], imgsz=64, conf=0.0, verbose=False)[0]) == 16
