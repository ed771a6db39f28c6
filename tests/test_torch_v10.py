"""YOLOv10 in the port vs the JAX package, on the same weights.

Module level (fp32, tolerance 1e-5), each in eval mode and in train mode,
where the BatchNorms normalise by the batch and move their running
statistics as flax's apply(..., mutable=["batch_stats"]) does: SCDown,
RepVGGDW, CIB (lk off and on, with and without its shortcut), C2fCIB, PSA
and the NMS-free v10Detect head (its one-to-many and one-to-one raw maps,
and its eval detections). The end2end loss (one-to-many at topk 10 plus
one-to-one at topk 1, the assigner's plain version) and its grads through
v10Detect against jax.grad; the one-to-one term alone leaves the head's
input without a gradient. Graph level: yolov10n at 64 px, unfused and
BN-folded (the port's fuse() and JAX's folded tree), within 2e-3; the six
YAMLs' parameter counts and yolov10n's strict bridge both ways; get_flops
against JAX's jaxpr product count, and ProfileModels. Serving: the
predictor's and the validator's end2end gates, embed and track on them,
the benchmark's mAP of an end2end Backend, a refused ensemble, a .ckpt
round trip and a CPU .pt2 program. int8 (tests/int8_parity.py): yolov10n
calibrated and quantized by both packages on the same batch (SCDown's,
CIB's and RepVGGDW's depth-wise convs and the light class branch float),
the calibration, the quant state, and the int8 graph's maps and
detections held to JAX's. The JAX
modules run under one jax.jit together and the graph under its own, eval
and train mode in the same one.
"""

import copy
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.nn import heads as JH
from improving_yolov8_cbam_swinblock_tpu.nn import modules as JM
from improving_yolov8_cbam_swinblock_tpu.nn import modules_extra as JE
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.utils.fuse import fuse_variables
from improving_yolov8_cbam_swinblock_tpu.utils.loss import detection_loss as jax_detection_loss
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, EnsembleModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.utils import model_utils as MU
from improving_yolov8_cbam_swinblock_tpu_torch.utils.benchmarks import ProfileModels
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import (fused_state_from_jax,
                                                                         jax_variables_from_state,
                                                                         state_dict_from_jax)
from improving_yolov8_cbam_swinblock_tpu_torch.utils.loss import detection_loss
from tests.int8_parity import (OUT_TOL, assert_calibration_close, assert_int8_geometry, assert_out_close,
                               assert_quant_state_close, int8_with_jax_state, jax_int8, port_int8)
from tests.test_torch_model import seeded_variables
from tests.test_torch_profile import jaxpr_product_flops
from tests.test_torch_yolo11 import close, nhwc, seeded_module, to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
MOD_TOL = 1e-5
GRAPH_TOL = 2e-3
# the graphs' JAX forward compiled at XLA's backend optimization level 0: a shorter compile, its convs summed in
# another order (far inside GRAPH_TOL, as tests/test_torch_obb.py measured)
QUICK = {"xla_backend_optimization_level": 0}
CFG = "yolov10n.yaml"
# JAX's parameter counts at nc=80 (its shape_init, without DFL's 16 fixed weights): n as counted here
# (test_yolov10n_bridges_both_ways), the others from its shape_init once, held as numbers so that these
# tests trace no larger graph
JAX_PARAMS = {"yolov10n.yaml": 2_775_504, "yolov10s.yaml": 8_128_256, "yolov10m.yaml": 16_576_752,
              "yolov10b.yaml": 20_574_368, "yolov10l.yaml": 25_888_672, "yolov10x.yaml": 31_808_944}
HEAD_CH = (16, 32, 64)  # v10Detect's input channels at module level; maps 8x8, 4x4, 2x2 (a 64 px input)
HEAD_NC = 3

# name: (JAX module, port module, NHWC input shape)
MODULES = {
    "scdown": lambda: (JE.SCDown(32, 3, 2), M.SCDown(24, 32, 3, 2), (2, 9, 8, 24)),
    "repvggdw": lambda: (JE.RepVGGDW(24), M.RepVGGDW(24), (2, 9, 8, 24)),
    # CIB: lk off with its residual; lk on without (c1 != c2); C2fCIB's blocks: lk on with the residual
    "cib": lambda: (JE.CIB(24, shortcut=True), M.CIB(24, 24, True), (2, 9, 8, 24)),
    "cib_lk_c1_ne_c2": lambda: (JE.CIB(32, shortcut=True, lk=True), M.CIB(24, 32, True, lk=True), (2, 9, 8, 24)),
    "c2fcib": lambda: (JE.C2fCIB(32, n=2, shortcut=True, lk=True), M.C2fCIB(24, 32, 2, True, True), (2, 9, 8, 24)),
    "psa": lambda: (JM.PSA(256), M.PSA(256, 256), (2, 6, 5, 256)),  # c 128: 2 heads of 64, key dim 32
}


def load_module(pm, v):
    """A JAX module's variables into a port module strictly, through the
    graph bridge: both as row 0 of a graph."""
    state = state_dict_from_jax({k: {"model_0": t} for k, t in v.items() if t})
    pm.load_state_dict({k.removeprefix("model.0."): t for k, t in state.items()}, strict=True)
    return pm.to(memory_format=torch.channels_last)


def assert_stats_moved(pm, moved, prefix=""):
    """The port module's running statistics after one train-mode forward equal flax's moved batch_stats."""
    want = state_dict_from_jax({"batch_stats": {"model_0": jax.tree.map(np.asarray, moved)}})
    got = pm.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        close(got[prefix + k.removeprefix("model.0.")].numpy(), want[k].numpy(), MOD_TOL)


@functools.cache
def jax_modules_run():
    """{name: (variables, input, eval output, train output, moved batch_stats)}
    of every MODULES case, all under one jax.jit (one compile, not one a case)."""
    cases = {}
    for name, make in MODULES.items():
        jm, _, shape = make()
        rng = np.random.default_rng(7)
        x = rng.normal(0, 1, shape).astype(np.float32)
        cases[name] = (jm, seeded_module(jm, jnp.asarray(x), rng), x)

    def run(vs, xs):
        out = {}
        for name, (jm, _, _) in cases.items():
            train, moved = jm.apply(vs[name], xs[name], train=True, mutable=["batch_stats"])
            out[name] = (jm.apply(vs[name], xs[name], train=False), train, moved["batch_stats"])
        return out

    out = jax.jit(run)({k: c[1] for k, c in cases.items()}, {k: jnp.asarray(c[2]) for k, c in cases.items()})
    out = jax.tree.map(np.asarray, out)
    return {k: (v, x, *out[k]) for k, (_, v, x) in cases.items()}


def jax_module_run(name):
    """(variables, input, eval output, train output, moved batch_stats) of a MODULES case."""
    return jax_modules_run()[name]


@pytest.mark.parametrize("name", list(MODULES))
@pytest.mark.parametrize("train", [False, True])
def test_module_matches_jax(name, train):
    v, x, ref_eval, ref_train, moved = jax_module_run(name)
    pm = load_module(MODULES[name]()[1], v).train(train)
    with torch.no_grad():
        out = pm(to_torch(x))
    close(nhwc(out), ref_train if train else ref_eval, MOD_TOL)
    if train:
        assert_stats_moved(pm, moved)


def test_cib_names_and_shortcut():
    """CIB's five convs are `cv1.0` to `cv1.4` (the reference's torch names),
    with RepVGGDW's `conv` and `conv1` at `cv1.2` under lk; the residual only
    where shortcut and c1 == c2."""
    names = set(M.CIB(24, 24, True, lk=True).state_dict())
    assert {f"cv1.{i}.conv.weight" for i in range(5)} - {"cv1.2.conv.weight"} <= names
    assert {"cv1.2.conv.conv.weight", "cv1.2.conv1.conv.weight", "cv1.2.conv1.bn.running_var"} <= names
    assert M.CIB(24, 24, True).add and not M.CIB(24, 32, True).add and not M.CIB(24, 24, False).add
    assert M.PSA(256, 256).attn.num_heads == 2


# ---------------------------------------------------------------------------------------------------------------
# v10Detect: module parity, the end2end loss and its grads, one jax.jit for all of it


def dets_match(got, ref, tol, conf=None):
    """Each image's detections (rows x1, y1, x2, y2, score, class) as sets:
    the top-k of the head orders near-equal scores by a rounding, so every
    row of `got` with a score must have a row of `ref` of the same class
    whose score and box agree within tol (of the largest box coordinate),
    and the sorted scores agree row by row; a row may only be missing from
    `ref` where its score is within tol of ref's k-th (the cut of the top-k,
    or of `conf`)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref[..., :4]).max()))
    for g, r in zip(got, ref):
        g, r = g[g[:, 4] > 0], r[r[:, 4] > 0]
        edge = min(r[:, 4].min() if len(r) else 1.0, 1.0 if conf is None else conf)
        n = min(len(g), len(r))
        np.testing.assert_allclose(np.sort(g[:, 4])[::-1][:n], np.sort(r[:, 4])[::-1][:n], atol=tol)
        assert abs(len(g) - len(r)) <= sum(abs(s - edge) <= tol for s in np.concatenate([g[:, 4], r[:, 4]]))
        for row in g:
            same = (r[:, 5] == row[5]) & (np.abs(r[:, 4] - row[4]) <= tol)
            found = same & (np.abs(r[:, :4] - row[:4]).max(1) <= tol * scale)
            assert found.any() or abs(row[4] - edge) <= tol, row


@functools.cache
def head_run():
    """v10Detect at module level, one jax.jit: the eval detections and maps,
    the train maps and moved statistics, and value_and_grad over the params
    and the inputs of the end2end loss on seeded targets (the totals of
    both terms and the one-to-many items as aux)."""
    rng = np.random.default_rng(10)
    jm = JH.v10Detect(nc=HEAD_NC, ch=HEAD_CH)
    xs = [rng.normal(0, 1, (2, 8 // 2**i, 8 // 2**i, c)).astype(np.float32) for i, c in enumerate(HEAD_CH)]
    v = seeded_module(jm, [jnp.asarray(x) for x in xs], rng)
    b, g = 2, 6
    cls = rng.integers(0, HEAD_NC, (b, g)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.05, 0.5, (b, g, 2))], -1)
    boxes = boxes.astype(np.float32)
    mask = (rng.random((b, g)) < 0.7).astype(np.float32)
    mask[0, 0] = 1.0
    targets = (cls, boxes, mask)

    def loss(params, xx):
        maps, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xx, train=True,
                           mutable=["batch_stats"])
        t1, items = jax_detection_loss(maps["one2many"], cls, boxes, mask, nc=HEAD_NC, tal_topk=10)
        t2, _ = jax_detection_loss(maps["one2one"], cls, boxes, mask, nc=HEAD_NC, tal_topk=1)
        return t1 + t2, (t1, t2, jnp.stack([items.box, items.cls, items.dfl]))

    def run(vv, xx):
        train, moved = jm.apply(vv, xx, train=True, mutable=["batch_stats"])
        grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(vv["params"], xx)
        return jm.apply(vv, xx, train=False), train, moved["batch_stats"], grads

    out = jax.jit(run)(v, [jnp.asarray(x) for x in xs])
    return v, xs, targets, jax.tree.map(np.asarray, out)


def head_port(train):
    v, xs = head_run()[:2]
    return load_module(M.v10Detect(HEAD_NC, HEAD_CH), v).train(train), [to_torch(x) for x in xs]


@pytest.mark.parametrize("train", [False, True])
def test_v10detect_matches_jax(train):
    """Train mode: both map lists and the moved statistics. Eval mode: the
    (B, k, 6) xyxy detections (k = min(300, A) = 84) and both map lists."""
    (ref_dets, ref_maps), ref_train, moved, _ = head_run()[3]
    pm, txs = head_port(train)
    with torch.no_grad():
        out = pm(txs)
    maps = out if train else out[1]
    for key in ("one2many", "one2one"):
        for f, rf in zip(maps[key], (ref_train if train else ref_maps)[key]):
            close(nhwc(f), rf, MOD_TOL)
    if train:
        assert_stats_moved(pm, moved)
    else:
        assert tuple(out[0].shape) == ref_dets.shape == (2, 84, 6)
        dets_match(out[0].numpy(), ref_dets, MOD_TOL * max(1.0, float(np.abs(ref_dets).max())))


def test_v10detect_names_and_bias_priors():
    """The one-to-one twin's names (`one2one_cv2.i.j`, `one2one_cv3.i.j.k`),
    plain depth-wise Convs in the light cls branch (the JAX package's
    `cv3_i_0_0`, no `dw` scope), and the bias priors of a seeded model on both branches."""
    head = DetectionModel(CFG, device="cpu").model[-1]
    names = set(head.state_dict())
    assert {"one2one_cv2.0.2.bias", "one2one_cv3.2.0.0.conv.weight", "cv3.1.1.1.bn.running_var"} <= names
    assert type(head.cv3[0][0][0]) is M.Conv and head.cv3[0][0][0].conv.groups == 64
    for cv2, cv3 in ((head.cv2, head.cv3), (head.one2one_cv2, head.one2one_cv3)):
        for a, b, s in zip(cv2, cv3, head.strides):
            assert torch.all(a[-1].bias == 1.0)
            torch.testing.assert_close(b[-1].bias, torch.full_like(b[-1].bias, np.log(5 / 80 / (640 / s) ** 2)))


def test_end2end_loss_and_grads_match_jax():
    """The port's loss on a v10Detect's train maps (one forward) against
    JAX's two detection_loss calls (topk 10 + topk 1) on the same weights
    and inputs: the total, each term, the one-to-many items (the trainer's),
    and the grads of every parameter and of the head's inputs."""
    _, _, (cls, boxes, mask), (_, _, _, ((jtotal, (jt1, jt2, jitems)), (jgp, jgx))) = head_run()
    pm, txs = head_port(True)
    txs = [t.clone().requires_grad_() for t in txs]
    maps = pm(txs)
    t = [torch.tensor(a) for a in (cls, boxes, mask)]
    total, items = detection_loss(maps, *t, nc=HEAD_NC)
    with torch.no_grad():
        t1 = detection_loss(maps["one2many"], *t, nc=HEAD_NC, tal_topk=10)[0]
        t2 = detection_loss(maps["one2one"], *t, nc=HEAD_NC, tal_topk=1)[0]
    total.backward()
    for got, ref in ((total, jtotal), (t1, jt1), (t2, jt2)):
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.stack(list(items)).numpy(), jitems, rtol=1e-4, atol=1e-5)
    assert float(jt1) > 0 and float(jt2) > 0 and jitems[0] > 0
    for tx, gx in zip(txs, jgx):
        np.testing.assert_allclose(nhwc(tx.grad), gx, rtol=1e-4, atol=1e-6)
    want = state_dict_from_jax({"params": {"model_0": jgp}})
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert set(grads) == {k.removeprefix("model.0.") for k in want}
    for k, g in want.items():
        got = grads[k.removeprefix("model.0.")]
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-4, atol=1e-6 * max(1.0, g.abs().max().item()),
                                   err_msg=k)


def test_one2one_term_leaves_the_head_input_without_gradient():
    """The one-to-one branch runs on detached inputs: its loss alone gives
    its own convs gradients (every cls conv; the box convs of the level its
    one anchor per GT falls on, here the first) and the head's inputs none."""
    _, _, (cls, boxes, mask), _ = head_run()
    pm, txs = head_port(True)
    txs = [t.clone().requires_grad_() for t in txs]
    total, _ = detection_loss(pm(txs)["one2one"], *(torch.tensor(a) for a in (cls, boxes, mask)), nc=HEAD_NC,
                              tal_topk=1)
    total.backward()
    assert all(t.grad is None for t in txs)
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for n, p in pm.named_parameters()
               if n.startswith(("one2one_cv3.", "one2one_cv2.0.")))
    assert all(p.grad is None for n, p in pm.named_parameters() if not n.startswith("one2one_"))


# ---------------------------------------------------------------------------------------------------------------
# graphs


FRAMES = np.random.default_rng(64).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)  # RGB
GRAPH_X = FRAMES.astype(np.float32) / 255.0


@functools.cache
def graph():
    """(JAX model, seeded variables, the port model loaded strictly, JAX's
    eval forward on GRAPH_X: detections and both map lists, and the jaxpr
    of that forward), one jax.jit."""
    jm = JaxDetectionModel(CFG)
    v = seeded_variables(jm, 64, np.random.default_rng(0))
    pm = DetectionModel(CFG, device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    traced = jax.jit(lambda vv, x: jm.apply(vv, x, train=False)).trace(v, jnp.asarray(GRAPH_X))
    dets, maps = traced.lower().compile(compiler_options=QUICK)(v, jnp.asarray(GRAPH_X))
    return jm, v, pm, np.asarray(dets), jax.tree.map(np.asarray, maps), traced.jaxpr


def assert_v10_close(pm):
    _, _, _, ref_dets, ref_maps, _ = graph()
    with torch.no_grad():
        dets, maps = pm(to_torch(GRAPH_X))
    for key in ("one2many", "one2one"):
        for f, rf in zip(maps[key], ref_maps[key]):
            np.testing.assert_allclose(nhwc(f), rf, rtol=GRAPH_TOL, atol=GRAPH_TOL)
    assert dets.shape == ref_dets.shape == (2, 84, 6)
    dets_match(dets.numpy(), ref_dets, GRAPH_TOL)


@pytest.mark.parametrize("how", ["unfused", "port_fuse", "jax_folded_tree"])
def test_yolov10n_matches_jax(how):
    """yolov10n at 64 px against JAX's unfused forward: unfused, folded by the
    port's fuse() (RepVGGDW's two branches each folded, kept apart), and
    JAX's fuse_variables tree read by fused_state_from_jax, which equals the
    port's own fold."""
    pm = graph()[2]
    if how == "port_fuse":
        pm = copy.deepcopy(pm).fuse()
        assert pm.is_fused and pm.end2end
    elif how == "jax_folded_tree":
        own = copy.deepcopy(pm).fuse()
        pm = DetectionModel(CFG, device="cpu").fuse()
        folded = jax.tree.map(np.asarray, jax.jit(fuse_variables)(graph()[1]))
        pm.load_state_dict(fused_state_from_jax(folded), strict=True)
        for k, t in own.state_dict().items():
            close(pm.state_dict()[k].numpy(), t.numpy(), 1e-6)
    assert_v10_close(pm)


@pytest.mark.parametrize("cfg", list(JAX_PARAMS))
def test_param_counts_equal_jax(cfg):
    """Each of the six graphs, built on the meta device, has JAX's parameter
    count and ends in v10Detect (end2end); its ungrouped convs take
    conv_int8's geometry."""
    with torch.device("meta"):
        pm = DetectionModel(cfg, device="meta")
    assert_int8_geometry(pm)
    assert sum(p.numel() for p in pm.parameters()) == JAX_PARAMS[cfg]
    assert pm.end2end and isinstance(pm.model[-1], M.v10Detect)


def test_yolov10n_bridges_both_ways():
    """JAX's parameter count, counted from its seeded variables (every leaf
    a distinct random draw); every leaf of them names one port tensor of its
    shape and the port has no other (strict load into a model on the meta
    device); the state written back as JAX variables is the same tree, bit
    for bit. The other sizes are built of the same blocks."""
    v = graph()[1]
    with torch.device("meta"):
        pm = DetectionModel(CFG, device="meta")
    assert sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(v["params"])) == JAX_PARAMS[CFG]
    pm.load_state_dict(state_dict_from_jax(v), strict=True, assign=True)
    back = jax_variables_from_state(pm)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    want, got = flat({k: v[k] for k in ("params", "batch_stats")}), flat(back)
    assert want.keys() == got.keys()
    assert all(np.array_equal(want[k], got[k]) for k in want)


def test_rows_as_jax_builds_them():
    """yolov10n: SCDown at rows 5, 7 and 20 (stride 2, depth-wise cv2 without
    activation), PSA at row 10 (2 heads), C2fCIB at row 22 with its own
    depth, shortcut and lk (RepVGGDW inside), strides 8, 16, 32; no other
    graph is end2end; the CIB and RepVGGDW rows build."""
    pm = graph()[2]
    assert [pm.model[i].type for i in (5, 7, 10, 20, 22, 23)] == ["SCDown", "SCDown", "PSA", "SCDown", "C2fCIB",
                                                                   "v10Detect"]
    assert pm.model[5].cv2.conv.groups == 128 and pm.model[5].cv2.act is False and pm.model[5].cv2.conv.stride == (2, 2)
    assert pm.model[10].attn.num_heads == 2 and len(pm.model[22].m) == 1 and pm.model[22].m[0].add
    assert isinstance(pm.model[22].m[0].cv1[2], M.RepVGGDW) and pm.strides == (8, 16, 32)
    assert not DetectionModel("yolov8n.yaml", device="cpu").end2end
    d = {"nc": 2, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "CIB", [16, True, 0.5, True]],
                               [-1, 1, "RepVGGDW", [16]]],
         "head": [[[1, 2], 1, "v10Detect", ["nc"]]]}
    m = DetectionModel(d, device="cpu")
    assert isinstance(m.model[1], M.CIB) and m.model[1].add and isinstance(m.model[2], M.RepVGGDW)
    with torch.no_grad():
        assert m(torch.rand(1, 3, 32, 32))[0].shape == (1, 300, 6)  # 512 anchors at stride 2, the top 300


def test_embed_refuses_the_head_and_pools_the_layer_before_it():
    """DetectionModel.embed refuses v10Detect's index as it refuses Detect's;
    layer 22 (the head's last input) pools to (B, 256)."""
    pm = graph()[2]
    x = to_torch(GRAPH_X)
    with torch.no_grad(), pytest.raises(ValueError, match="layer 23 is v10Detect"):
        pm.embed(x, [-1])
    with torch.no_grad():
        e = pm.embed(x, [22])
    assert e.shape == (2, 256)


def test_get_flops_equals_the_jaxpr_product_count():
    """get_flops of one 64 px image against the products of JAX's forward
    jaxpr at batch 2 (the graph test's trace), which count twice as many;
    ProfileModels' row of yolov10n (its bf16 forward returns the detections
    and both map dicts) carries the same count and JAX's parameters."""
    pm, jaxpr = graph()[2], graph()[5]
    flops = MU.get_flops(pm, 64)
    assert 2 * round(flops * 1e9) == jaxpr_product_flops(jaxpr.jaxpr)
    (row,) = ProfileModels([CFG], num_timed_runs=3, num_warmup_runs=1, imgsz=64, device="cpu").profile()
    assert row["params_M"] == round(JAX_PARAMS[CFG] / 1e6, 2) and row["GFLOPs"] == round(flops, 2)
    assert row["ms_mean"] > 0


# ---------------------------------------------------------------------------------------------------------------
# predict, val, ensembles, int8, files, programs


def yolo_v10n():
    y = YOLO(CFG, device="cpu")
    y.model.load_state_dict(graph()[2].state_dict())
    return y


@functools.cache
def served():
    """yolov10n on the graph test's weights, BN-folded as predict serves it
    (one YOLO for the tests that only serve it)."""
    return yolo_v10n().fuse()


def test_predict_and_val_gate_the_head_detections_as_jax():
    """YOLO.predict (BN-folded) on the frames: no NMS, the head's detections
    with the rows at or below conf zeroed (the JAX predictor's gate on the
    same forward; boxes clipped to the frame), augment=True ignored as in
    JAX; the validator's forward keeps every row above 0.001."""
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import DetectionValidator

    ref = graph()[3].copy()
    s = np.sort(ref[..., 4].ravel())
    mid = s[len(s) // 4:3 * len(s) // 4]
    i = int(np.argmax(np.diff(mid)))
    conf = float(mid[i] + mid[i + 1]) / 2  # in the widest gap of the middle scores: no row near the gate
    gated = ref * (ref[..., 4:5] > conf)
    gated[..., :4] = gated[..., :4].clip(0, 64)
    y = served()
    bgr = np.ascontiguousarray(FRAMES[..., ::-1])
    for augment in (False, True):
        res = y.predict(bgr, imgsz=64, conf=conf, augment=augment, verbose=False)
        assert y.is_fused and [len(r) for r in res] == [int((g[:, 4] > 0).sum()) for g in gated]
        got = np.zeros_like(gated)
        for i, r in enumerate(res):
            got[i, :len(r)] = r.boxes.data
        dets_match(got, gated, GRAPH_TOL, conf=conf)
    val = DetectionValidator(y.model, None, SimpleNamespace(max_det=300))
    dets = val.forward_nms(FRAMES)
    assert dets.shape == (2, 84, 6) and (dets[..., 4] > 0).sum() == (ref[..., 4] > 0.001).sum()
    dets_match(dets, ref * (ref[..., 4:5] > 0.001), GRAPH_TOL)


def test_ensemble_and_int8_refuse_yolov10():
    """An ensemble refuses yolov10n; int8 takes it now (it was refused,
    naming SCDown, until the JAX gate was ported): every Conv gets int8
    weights, the grouped ones keep their float path, and the quantized
    model gives the head's (B, 84, 6) detections."""
    with pytest.raises(ValueError, match="NMS-ensembled"):
        EnsembleModel([DetectionModel("yolov8n.yaml", device="cpu"), graph()[2]])
    m = copy.deepcopy(graph()[2]).fuse()
    quantize_model(m, [np.zeros((1, 64, 64, 3), np.uint8)])
    convs = [c for c in m.modules() if isinstance(c, M.Conv)]
    assert all(c.w_int8 is not None and c.runs_int8 == (c.conv.groups == 1) for c in convs)
    assert m.model[5].cv2.conv.groups > 1 and not m.model[5].cv2.runs_int8 and m.model[5].cv1.runs_int8
    with torch.no_grad():
        dets = m(to_torch(GRAPH_X))[0]
    assert tuple(dets.shape) == (2, 84, 6) and torch.isfinite(dets).all()


INT8_FRAMES = np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)


@functools.cache
def int8_run():
    """(port, JAX) int8 paths of yolov10n's seeded weights on INT8_FRAMES (one batch), JAX's forward on GRAPH_X."""
    jm, v, pm = graph()[:3]
    return port_int8(pm, INT8_FRAMES), jax_int8(jm, v, INT8_FRAMES, GRAPH_X)


def test_int8_calibration_matches_jax():
    assert_calibration_close(*int8_run())


def test_int8_quant_state_matches_jax():
    assert_quant_state_close(*int8_run())


def test_int8_graph_matches_jax():
    """yolov10n's int8 graph with JAX's quant state carried in against JAX's
    int8 graph: both map lists within OUT_TOL, and the (B, 84, 6) detections
    as sets (dets_match) within OUT_TOL of the largest box coordinate."""
    port, ref = int8_run()
    m = int8_with_jax_state(port, ref)
    with torch.no_grad():
        dets, maps = m(to_torch(GRAPH_X))
    rdets, rmaps = ref["out"]
    for key in ("one2many", "one2one"):
        for f, rf in zip(maps[key], rmaps[key]):
            assert_out_close(nhwc(f), rf)
    assert tuple(dets.shape) == rdets.shape == (2, 84, 6)
    dets_match(dets.numpy(), rdets, OUT_TOL)


def test_ckpt_round_trip_is_bit_for_bit(tmp_path):
    """YOLO.save of yolov10n as a JAX-format .ckpt, read back by YOLO(path):
    the same state, bit for bit, and JAX's forward."""
    y = yolo_v10n()
    y.save(str(tmp_path / "v10n.ckpt"))
    back = YOLO(str(tmp_path / "v10n.ckpt"), device="cpu")
    assert back.model.end2end and not back.is_fused
    want = y.model.state_dict()
    assert all(torch.equal(t, want[k]) for k, t in back.model.state_dict().items())
    assert_v10_close(back.model)


def test_pt2_program_equals_the_live_model(tmp_path, capsys):
    """A CPU .pt2 of yolov10n (BN-folded, as predict serves it) asked for
    with nms=True: the option is dropped with a warning (the head gives the
    NMS-free detections already), the program returns the live model's
    (B, 84, 6) bit for bit at batch 2, its sidecar says end2end with the
    xyxy layout, and Backend serves it as end2end."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend

    y = served()
    path = y.export(format="pt2", imgsz=64, batch=2, nms=True, project=str(tmp_path))
    assert "nms=True on a YOLOv10" in capsys.readouterr().out
    assert path.endswith("model_64.pt2")
    be = Backend(path, device="cpu")
    assert be.end2end and be.metadata["end2end"] and not be.metadata["nms"] and be.metadata["max_det"] == 300
    assert "xyxy" in be.metadata["layout"]
    out = be(FRAMES)
    with torch.no_grad():
        live = y.model(torch.from_numpy(FRAMES).permute(0, 3, 1, 2).float() / 255.0)[0]
    assert out.shape == (2, 84, 6)
    np.testing.assert_array_equal(out, live.numpy())
    assert Backend(y.model).end2end


def test_benchmark_map_gates_an_end2end_backend():
    """YOLO.benchmark's mAP of an end2end Backend (utils/benchmarks.py) gates
    its detections by the val conf as the validator does, with no NMS: on a
    batch whose GT are the model's own top detections it equals the
    validator's metrics, and finds them."""
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import DetectionValidator
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.benchmarks import _eval_backend_map

    y = served()
    val = DetectionValidator(y.model, None, SimpleNamespace(max_det=300))
    top = val.forward_nms(FRAMES)[:, :4]  # (2, 4, 6): each image's best four, xyxy pixels
    xywh = np.concatenate([(top[..., :2] + top[..., 2:4]) / 2, top[..., 2:4] - top[..., :2]], -1) / 64
    batch = {"img": FRAMES, "cls": top[..., 5].astype(np.int32), "bboxes": xywh.astype(np.float32),
             "mask": np.ones((2, 4), np.float32)}
    be = Backend(y.model)
    assert be.end2end
    got = _eval_backend_map(be, [batch], y.model.names, 300)
    val.update_metrics(val.forward_nms(FRAMES), batch)
    want = val.metrics.compute()
    assert got == want and got["mAP50"] > 0.5


def test_track_and_embed_ride_on_the_end2end_predictor():
    """YOLO.track with ByteTrack over three frames takes the predictor's
    gated detections (boxes of 7 columns where a track is active), and
    YOLO.embed's default layer is the one before v10Detect (row 22, 256
    channels at scale n)."""
    y = served()
    frames = [np.ascontiguousarray(FRAMES[i % 2, ..., ::-1]) for i in range(3)]
    conf = float(np.median(graph()[3][..., 4]))
    res = y.track(frames, tracker="bytetrack.yaml", imgsz=64, conf=conf, verbose=False)
    assert len(res) == 3 and all(len(r) > 0 for r in res)
    assert any(r.boxes.is_track and len(r.track_ids) == len(r) for r in res[1:])
    assert y.embed(frames, imgsz=64).shape == (3, 256)
